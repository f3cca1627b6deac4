"""Compiled execution on the card: CUDA-graph capture, the port's ``jax.jit``.

The JAX package compiles its step functions with ``jax.jit``: the serving
engine's prefill, write-prompt and decode steps and ``SameDiff.output``'s
whole-graph function. On the card the port's counterpart is a
:class:`CapturedUnit`: a function whose kernels are recorded once per input
signature into a ``torch.cuda.CUDAGraph`` and replayed afterwards, so a
call costs one graph launch instead of one Python dispatch per op.

For each new signature (the arguments' shapes, dtypes and strides, the
caller's ``key`` and the environment's helper mode) the first call

1. copies the arguments into static input buffers the unit owns — an
   ``owned_inputs`` unit's arguments are themselves its static buffers, and
   their addresses join the signature;
2. warms up: runs the function once eagerly on the unit's side stream, so
   kernel builds, ``cudaFuncSetAttribute``, first-use allocations and the
   K-major weight copies all happen outside the capture;
3. captures the function into a graph. The unit's graphs share one memory
   pool (``torch.cuda.graph_pool_handle()``), and its ``torch.Generator``
   objects are registered with each graph, so every replay draws new
   numbers;
4. copies the warm-up's results into the graph's output buffers and
   returns those: the first call runs the function once.

Later calls copy each argument into its static buffer (skipped when it is
the tensor loaded last time, unchanged since), refresh the derived buffers
whose source changed (:func:`note_derived`), and replay. The outputs are
the graph's own buffers: they hold until the unit's next call.

**Training units.** A training step (``jax.jit(train_step,
donate_argnums=...)`` in the JAX package) updates its parameters, updater
state, layer state and iteration in place: the caller passes those
tensors as ``state=``. They are the graph's static buffers themselves,
never copied; their addresses, shapes and dtypes join the signature (a
trainer that rebinds a parameter gets a new capture, never a replay that
writes a freed buffer). Such a capture — the shapes of a signature
already captured, only addresses moved — is counted in ``moved`` and,
when the call names its ledger entry, recorded in the recompile ledger
with the cause ``state_moved``: a trainer that keeps its buffers never
records one. A replay writes them behind PyTorch's back, so
after each replay the unit moves the ``_version`` of every one
(:func:`bump_versions`): ``_Static.load`` of another unit, the derived
buffers and ``cuda_matmul.kmajor_weight`` then see the change. A K-major
copy a training step reads is remade inside its graph, from the weight
the replay has at that point (:func:`remakes_inside`): no derived buffer
of a training unit is refreshed before a replay, and a multi-step graph
reads each step's own weights.

**Launch accounting.** A replay runs no Python, so the wrappers' launch
counters and ``dl4j_tpu_helper_dispatch_total`` would miss it. The warm-up
counts as it launches. The capture launches nothing: the launch counters
it moved are set back and what they moved is kept as one replay's
launches, and the registry's dispatch decisions taken inside it are
tallied apart (:func:`tally_dispatch`); every replay then adds both. So
the counters hold the launches the card ran: one run a call.

**Derived buffers.** A kernel may read a copy derived from a weight (the
K-major copies of ``cuda_matmul.kmajor_weight``). The copy is made in the
warm-up and the graph reads it in place. A weight changed afterwards (in
place, or loaded into a static buffer) moves its ``_version``, and the copy
is remade into the same buffer before the next replay; a replay never
reads a stale copy.

On the CPU — which only the tests ask for — the function runs eagerly on
every call, as it does on any device under :func:`disable_capture`, the
counterpart of ``jax.disable_jit``. On the card, a capture that fails
raises; nothing runs eagerly in its place.
"""

from __future__ import annotations

import contextlib
import gc
import threading
import time
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from deeplearning4j_tpu_torch.environment import environment

# one capture in the process at a time (a CUDA rule)
_CAPTURE_LOCK = threading.Lock()
_STATE_LOCK = threading.Lock()
_DISABLED = 0  # depth of open disable_capture() blocks, process-wide
_RECORDING = threading.local()  # .derived: the capture underway here
# (.training: that capture is a training unit's, whose graph remakes the
# K-major copies it reads)


@contextlib.contextmanager
def disable_capture():
    """Run every :class:`CapturedUnit` eagerly inside the block, on every
    thread (the serving engine's worker too): the counterpart of
    ``jax.disable_jit()``. Captured graphs are kept for later."""
    global _DISABLED
    with _STATE_LOCK:
        _DISABLED += 1
    try:
        yield
    finally:
        with _STATE_LOCK:
            _DISABLED -= 1


def capture_enabled() -> bool:
    return _DISABLED == 0


def _layouts(tensors: Sequence[torch.Tensor]) -> tuple:
    return tuple((tuple(t.shape), t.dtype) for t in tensors)


def _pointers(tensors: Sequence[torch.Tensor]) -> tuple:
    return tuple(t.data_ptr() for t in tensors)


def _version_key(t: torch.Tensor) -> tuple:
    return (t._version, t.data_ptr(), tuple(t.shape), t.stride())


class _Derived:
    """A buffer a captured graph reads that is derived from ``source``;
    ``remake(source, buffer)`` recomputes it in place."""

    def __init__(self, source: torch.Tensor, buffer: torch.Tensor,
                 remake: Callable[[torch.Tensor, torch.Tensor], None]):
        self.source, self.buffer, self.remake = source, buffer, remake
        self.key = _version_key(source)

    def refresh(self) -> bool:
        """Remake the buffer if the source changed; True if it did."""
        key = _version_key(self.source)
        if key == self.key:
            return False
        self.remake(self.source, self.buffer)
        self.key = key
        return True


def remakes_inside() -> bool:
    """Whether a training unit is warming up or capturing on this thread:
    a copy derived from a weight is then made inside the graph, from the
    weight as the replay finds it, and is neither kept nor noted."""
    return bool(getattr(_RECORDING, "training", False))


def bump_versions(tensors: Sequence[torch.Tensor]) -> None:
    """Move the ``_version`` of tensors a kernel or a graph replay wrote
    in place (PyTorch's own in-place ops do it themselves)."""
    torch.autograd.graph.increment_version(list(tensors))


def note_derived(source: torch.Tensor, buffer: torch.Tensor,
                 remake: Callable[[torch.Tensor, torch.Tensor], None]
                 ) -> None:
    """Tell the unit warming up or capturing on this thread that its graph
    reads ``buffer``, made from ``source``; a no-op anywhere else."""
    derived = getattr(_RECORDING, "derived", None)
    if derived is not None and id(buffer) not in derived:
        derived[id(buffer)] = _Derived(source, buffer, remake)


class _Static:
    """A static input buffer and what was last loaded into it."""

    def __init__(self, buffer: torch.Tensor):
        self.buffer = buffer
        self._src: Optional[weakref.ref] = None
        self._versions = (-1, -1)

    def load(self, src: torch.Tensor) -> bool:
        """Copy ``src`` in unless it is the tensor loaded last time and
        neither it nor the buffer changed since; True if it copied."""
        if src is self.buffer:
            return False
        tracked = not src.is_inference()
        if (tracked and self._src is not None and self._src() is src
                and (src._version, self.buffer._version) == self._versions):
            return False
        self.buffer.copy_(src)
        if tracked:
            self._src = weakref.ref(src)
            self._versions = (src._version, self.buffer._version)
        else:
            self._src = None
        return True


def _counter_cells() -> List[Tuple[Any, str]]:
    """(object, attribute) of every kernel wrapper's launch counter."""
    from deeplearning4j_tpu_torch.ops import cuda_attention as ca
    from deeplearning4j_tpu_torch.ops import cuda_convbn as cc
    from deeplearning4j_tpu_torch.ops import cuda_layernorm as cl
    from deeplearning4j_tpu_torch.ops import cuda_matmul as cm
    from deeplearning4j_tpu_torch.ops import cuda_quantized as cq
    from deeplearning4j_tpu_torch.ops import cuda_updater as cu

    cells = list(dict.fromkeys(ca.KERNELS.values()))
    cells += [(cm.fused_matmul, a) for a in
              ("launches", "sm90_launches", "sm90_f32_launches")]
    cells += [(cm.kmajor_weight, "copies"), (cq.int8_matmul, "launches"),
              (cq.int8_matmul, "sm90_launches"), (cq.row_quantize, "launches"),
              (cl.fused_layer_norm_kernel, "launches"),
              (cc.bn_matmul_stats, "launches"),
              (cc.bn_matmul_stats, "sm90_launches"),
              (cu.fused_updater, "launches"), (cu.fused_updater, "leaves")]
    return cells


_DISPATCH = "dl4j_tpu_helper_dispatch_total"


def tally_dispatch(op: str, impl: str, reason: str) -> bool:
    """Count a registry dispatch decision taken inside a capture underway
    on this thread into that capture's tally (True), instead of
    ``dl4j_tpu_helper_dispatch_total``: a capture runs nothing, and each
    later replay adds the tally. False anywhere else."""
    tally = getattr(_RECORDING, "dispatch", None)
    if tally is None:
        return False
    key = (op, impl, reason)
    tally[key] = tally.get(key, 0) + 1
    return True


def _pool_bytes(pool) -> int:
    """Bytes of the segments the caching allocator holds for ``pool``: a
    graph pool keeps every segment it took while its graphs live, so this
    is the pool's peak."""
    return sum(seg["total_size"]
               for seg in torch.cuda.memory._snapshot()["segments"]
               if tuple(seg.get("segment_pool_id", ())) == tuple(pool))


class _Graph:
    """One signature's capture: the graph, its static inputs and outputs,
    the state it writes in place, the derived buffers it reads and what
    one replay launches."""

    def __init__(self, graph, inputs, outputs, derived, launches, dispatch,
                 state=()):
        self.graph = graph
        self.inputs: List[_Static] = inputs
        self.outputs = outputs
        self.state: Tuple[torch.Tensor, ...] = tuple(state)
        self.derived: List[_Derived] = derived
        self.launches: List[Tuple[Tuple[Any, str], int]] = launches
        self.dispatch: Dict[Tuple[str, str, str], int] = dispatch


def _tensors(out) -> List[torch.Tensor]:
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, dict):
        out = list(out.values())
    if out is None:
        return []
    if isinstance(out, (tuple, list)) and all(
            isinstance(t, torch.Tensor) for t in out):
        return list(out)
    raise TypeError("a captured function returns a tensor, a tuple or list "
                    f"of tensors, a dict of tensors or None; got {type(out)}")


class CapturedUnit:
    """A function run as a CUDA-graph capture on the card (module
    docstring). ``fn(*args)`` takes tensors and returns a tensor, a tuple
    or dict of tensors, or None. ``generators``: the ``torch.Generator``
    objects ``fn`` draws from. ``owned_inputs``: the arguments are the
    caller's persistent buffers, read in place and never copied. A call's
    ``state``: the tensors ``fn`` reads and writes in place without taking
    them as arguments (a training unit's parameters and updater state);
    ``reads``: the tensors it reads in place without taking them as
    arguments and never writes. The addresses of both join the signature;
    the versions of ``state`` move after each replay.

    Kept for the records: ``captures``, ``moved`` (the captures that
    only moved addresses called for), ``pool_bytes`` (the segments the
    shared pool holds after the last capture: its peak), ``static_bytes``
    (its static input buffers) and ``timings``, the ``time.perf_counter()`` readings
    that bound the last capture's warm-up and capture (start, warm-up end,
    capture end)."""

    def __init__(self, fn: Callable[..., Any], *, device,
                 generators: Sequence[torch.Generator] = (),
                 owned_inputs: bool = False, name: str = "unit"):
        self.fn = fn
        self.device = torch.device(device)
        self.name = name
        self._generators = tuple(generators)
        self._owned = owned_inputs
        self._graphs: Dict[tuple, _Graph] = {}
        self._statics: Dict[tuple, _Static] = {}
        # id(buffer) -> the derived buffer, shared by the unit's graphs
        self._derived: Dict[int, _Derived] = {}
        self._pool = None
        self._stream: Optional[torch.cuda.Stream] = None
        self._layouts_seen: set = set()  # the signatures less addresses
        self.captures = self.moved = 0
        self.pool_bytes = 0
        self.static_bytes = 0
        self.timings: Optional[Tuple[float, float, float]] = None

    def captured(self) -> bool:
        """Whether this call would replay (or capture) a graph."""
        return self.device.type == "cuda" and capture_enabled()

    def __call__(self, *args: torch.Tensor, key: Any = (),
                 state: Sequence[torch.Tensor] = (),
                 reads: Sequence[torch.Tensor] = (),
                 ledger: Optional[Tuple[str, str]] = None):
        """``ledger``: (graph, signature) under which a capture that only
        moved addresses is recorded (cause ``state_moved``)."""
        if not self.captured():
            return self.fn(*args)
        layout = (key, environment().helper_mode,
                  tuple((tuple(a.shape), a.dtype, a.stride()) for a in args),
                  _layouts(state), _layouts(reads))
        sig = (layout, _pointers(args) if self._owned else (),
               _pointers(state), _pointers(reads))
        g = self._graphs.get(sig)
        if g is None:
            if layout in self._layouts_seen:
                self.moved += 1
                if ledger is not None:
                    from deeplearning4j_tpu_torch import observe

                    observe.ledger().record(
                        graph=ledger[0], key=self.name, signature=ledger[1],
                        cause="state_moved")
            self._layouts_seen.add(layout)
            return self._capture(sig, args, tuple(state))
        with torch.cuda.device(self.device):
            for st, a in zip(g.inputs, args):
                st.load(a)
            for d in g.derived:
                d.refresh()
            g.graph.replay()
        if g.state:
            bump_versions(g.state)
        for (obj, attr), n in g.launches:
            setattr(obj, attr, getattr(obj, attr) + n)
        if g.dispatch:
            from deeplearning4j_tpu_torch import observe

            m = observe.metrics()
            for (op, impl, reason), n in g.dispatch.items():
                m.counter(_DISPATCH, op=op, impl=impl, reason=reason).inc(n)
        return g.outputs

    def _static(self, i: int, a: torch.Tensor) -> _Static:
        """The static buffer of argument ``i`` at ``a``'s layout — shared
        by every signature of the unit that has that layout there."""
        k = (i, tuple(a.shape), a.dtype, a.stride())
        st = self._statics.get(k)
        if st is None:
            st = _Static(torch.empty_like(a))
            self._statics[k] = st
            self.static_bytes += st.buffer.numel() * st.buffer.element_size()
        return st

    def _capture(self, sig: tuple, args: Sequence[torch.Tensor],
                 state: Tuple[torch.Tensor, ...] = ()):
        """Warm up, capture, and return the warm-up's results in the
        graph's output buffers: the first call runs the function once."""
        dev = self.device
        with torch.cuda.device(dev):
            if self._owned:
                inputs = [_Static(a) for a in args]
            else:
                inputs = [self._static(i, a) for i, a in enumerate(args)]
                for st, a in zip(inputs, args):
                    st.load(a)
            statics = [st.buffer for st in inputs]
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
                self._stream = torch.cuda.Stream(dev)
            graph = torch.cuda.CUDAGraph()
            if self._generators and not hasattr(graph,
                                                "register_generator_state"):
                raise RuntimeError(
                    f"{self.name}: this torch cannot register a "
                    f"torch.Generator with a CUDA graph "
                    f"(CUDAGraph.register_generator_state)")
            cells = _counter_cells()
            derived: Dict[int, _Derived] = {}
            dispatch: Dict[Tuple[str, str, str], int] = {}
            with _CAPTURE_LOCK:
                _RECORDING.derived = derived
                _RECORDING.training = bool(state)
                try:
                    t0 = time.perf_counter()
                    self._stream.wait_stream(torch.cuda.current_stream(dev))
                    with torch.cuda.stream(self._stream):
                        result = self.fn(*statics)  # the warm-up
                    torch.cuda.synchronize(dev)
                    t1 = time.perf_counter()
                    before = [getattr(o, a) for o, a in cells]
                    for gen in self._generators:
                        graph.register_generator_state(gen)
                    _RECORDING.dispatch = dispatch
                    # the engine captures on its worker thread while callers
                    # submit on theirs: only this thread's calls are checked.
                    # torch.cuda.graph collects garbage as it starts; the
                    # collector stays off until the capture ends, so no
                    # unreachable graph is destroyed (cudaGraphExecDestroy,
                    # its pool freed) in the middle of this one
                    collecting = gc.isenabled()
                    with torch.cuda.graph(graph, pool=self._pool,
                                          stream=self._stream,
                                          capture_error_mode="thread_local"):
                        gc.disable()
                        try:
                            outputs = self.fn(*statics)
                        finally:
                            if collecting:
                                gc.enable()
                    t2 = time.perf_counter()
                finally:
                    _RECORDING.derived = _RECORDING.dispatch = None
                    _RECORDING.training = False
            self.pool_bytes = _pool_bytes(self._pool)
            # the capture launched nothing: its counts stand for a replay
            launches = [(c, getattr(*c) - b) for c, b in zip(cells, before)
                        if getattr(*c) != b]
            for (obj, attr), b in zip(cells, before):
                setattr(obj, attr, b)
            for out, warm in zip(_tensors(outputs), _tensors(result)):
                out.copy_(warm)
        reads = [self._derived.setdefault(i, d) for i, d in derived.items()]
        self._graphs[sig] = _Graph(graph, inputs, outputs, reads, launches,
                                   dispatch, state)
        self.captures += 1
        self.timings = (t0, t1, t2)
        return outputs

    def reset(self) -> None:
        """Drop every graph, static buffer and the pool."""
        self._graphs.clear()
        self._layouts_seen.clear()
        self._statics.clear()
        self._derived.clear()
        self._pool = None
        self.pool_bytes = self.static_bytes = 0
