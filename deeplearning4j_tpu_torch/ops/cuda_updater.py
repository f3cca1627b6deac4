"""Fused updater step: the ``fused_updater_step`` op, its plain PyTorch
version and its hand-written CUDA kernel.

Counterpart of ``deeplearning4j_tpu/ops/pallas_updater.py``::

    new_param, *new_state = fused_updater_step(param, grad, lr, step,
                                               *state, kind="Nesterovs", ...)

* :func:`fused_updater_step` (the op's generic impl, the plain version) is
  ``pallas_updater.py:59-76``: it calls the same ``Updater.apply`` as the
  unfused step and returns ``param - update``. A bfloat16/float16 leaf is
  computed in float32 and each output rounded once to the leaf's dtype,
  as the Pallas kernel stores them.
* :func:`fused_updater_multi` launches ``csrc/fused_updater.cu``
  (replacing ``_kernel``, ``pallas_updater.py:84``, via
  ``fused_updater_helper``) over a group of leaves that share kind,
  hyperparameters, lr, step and dtype: one launch for up to
  :data:`TABLE_LEAVES` leaves, reading each leaf's param, grad and state
  buffers once and writing its new param and state once, for all 11
  kinds, in float32, bfloat16 or float16. The kernel reads its
  coefficients (the learning rate, Adam's bias-corrected step...) from
  an 8-float device buffer, :meth:`Updater.coefficients`, computed on the
  device from the trainer's iteration tensor: a CUDA graph that captured
  the launch reads each replay's values. Out of place (the wrapper
  allocates the outputs: views into one flat buffer per output) or in
  place (``inplace=True``: the kernel writes each leaf's parameter and
  state buffers themselves, and the wrapper moves their ``_version``, as
  a PyTorch in-place op does — the training steps' counterpart of the
  JAX step's donated buffers). Given CPU tensors it computes the plain
  version leaf by leaf; given CUDA tensors it launches or raises. :func:`fused_updater` is the per-leaf
  entry, a group of one. Launches are counted in
  ``fused_updater.launches`` and leaves in ``fused_updater.leaves``.
  ``Updater.apply_fused_many`` (``nn/updater.py``) packs a train step's
  leaves into such groups.

:func:`fused_updater_usable` mirrors the JAX gate ``_usable`` (a floating
leaf, equal shapes, the kind's number of state buffers) without the
``min_size`` crossover, which is a TPU tuning-table figure: on the card
every floating leaf takes the kernel. A float64 leaf passes the gate (as
it passes the JAX one) and the wrapper raises on it: the kernel computes
in float32.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.ops import _build
from deeplearning4j_tpu_torch.ops.registry import op

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_P = ctypes.c_void_p
_I = ctypes.c_int
# rows starts | n_leaves kind dtype | coef | stream
_ARGS = (_P, _P, _I, _I, _I, _P, _P)


@functools.lru_cache(maxsize=None)
def _updater_and_keys(kind: str, hyper_items: Tuple[Tuple[str, object], ...]):
    """(updater instance, sorted state keys, kind code) for a
    (kind, hyperparameters) pair. Imported late: nn.updater imports the
    registry back."""
    from deeplearning4j_tpu_torch.nn.updater import UPDATERS

    if kind not in UPDATERS:
        raise ValueError(f"fused_updater_step: unknown updater kind '{kind}'"
                         f"; valid: {sorted(UPDATERS)}")
    upd = UPDATERS[kind](**dict(hyper_items))
    keys = tuple(sorted(upd.init_state(torch.zeros(()))))
    return upd, keys, list(UPDATERS).index(kind)


def _resolve(kind, hyper, state):
    upd, keys, code = _updater_and_keys(kind, tuple(sorted(hyper.items())))
    if len(state) != len(keys):
        raise ValueError(
            f"fused_updater_step[{kind}]: expected {len(keys)} state "
            f"arrays {list(keys)}, got {len(state)}")
    return upd, keys, code


def _scalar(v) -> torch.Tensor:
    """lr as the float32 0-d tensor the updater math takes: a tensor stays
    on its device (the trainers' learning rate lives on theirs), a number
    becomes a CPU scalar."""
    if isinstance(v, torch.Tensor):
        return v.to(torch.float32)
    return torch.as_tensor(v, dtype=torch.float32, device="cpu")


@op("fused_updater_step")
def fused_updater_step(param, grad, lr, step, *state, kind: str = "Sgd",
                       **hyper):
    """One optimizer step for one leaf: ``(new_param, *new_state)``.

    ``state`` rides positionally in sorted-key order (Adam: m, v);
    ``kind`` names an ``nn/updater.py`` class and ``hyper`` its constructor
    fields (``learning_rate`` excluded — ``lr`` is the scheduled value)."""
    upd, keys, _ = _resolve(kind, hyper, state)
    lr = _scalar(lr)
    wide = torch.promote_types(param.dtype, torch.float32)
    u, new = upd.apply(grad.to(wide),
                       {k: s.to(wide) for k, s in zip(keys, state)}, lr, step)
    return ((param.to(wide) - u).to(param.dtype),) + tuple(
        new[k].to(s.dtype) for k, s in zip(keys, state))


# the kernel's plan (csrc/fused_updater.cu): leaves a launch's table holds
# (kCap), and the bytes of each buffer one block updates (kChunkBytes: 256
# threads x 4 x 16 bytes)
TABLE_LEAVES = 256
CHUNK_BYTES = 256 * 4 * 16
# one row of the table: p, g, s0, s1, s2, op, o0, o1, o2, n, n_vec
_ROW = 11


def chunk_elements(elem_size: int) -> int:
    """Elements of one block's chunk of a leaf of ``elem_size``-byte
    elements."""
    return CHUNK_BYTES // elem_size


def plan_launches(numels, elem_size: int):
    """The launches of a group: a list of ``(leaf indices, chunk starts)``,
    at most :data:`TABLE_LEAVES` leaves each, where ``starts[i]`` is the first
    block of the launch's i-th leaf and ``starts[-1]`` the launch's block
    count (an exclusive prefix sum of ``ceil(n / chunk)``). Empty leaves
    take no block and no table row."""
    chunk = chunk_elements(elem_size)
    launches, idx, starts, total = [], [], [], 0
    for i, n in enumerate(numels):
        if n == 0:
            continue
        if len(idx) == TABLE_LEAVES:
            launches.append((idx, starts + [total]))
            idx, starts, total = [], [], 0
        idx.append(i)
        starts.append(total)
        total += -(-n // chunk)
    if idx:
        launches.append((idx, starts + [total]))
    return launches


def vector_count(n: int, elem_size: int, ptrs) -> int:
    """16-byte vectors of a leaf on the kernel's vector path: ``n`` //
    (16 / elem_size) when every pointer of the leaf is 16-byte aligned,
    else 0 (the whole leaf takes the scalar path)."""
    if any(p % 16 for p in ptrs):
        return 0
    return n // (16 // elem_size)


def _flat_outputs(shapes, dtype, device, n_out):
    """``n_out`` lists of new tensors of ``shapes``: views into one flat
    buffer per output (new param, each state buffer), every leaf starting
    on a 16-byte boundary so the vector path takes it. Views share their
    buffer's version counter: an in-place change of one leaf moves every
    leaf's ``_version`` (``cuda_matmul.kmajor_weight`` then remakes its
    copies, never keeps a stale one)."""
    align = 16 // dtype.itemsize
    offs, total = [], 0
    for s in shapes:
        offs.append(total)
        total += -(-math.prod(s) // align) * align
    outs = []
    for _ in range(n_out):
        flat = torch.empty(total, dtype=dtype, device=device)
        outs.append([flat[o:o + math.prod(s)].view(s)
                     for o, s in zip(offs, shapes)])
    return outs


def fused_updater_multi(params, grads, states, lr, step, *,
                        kind: str = "Sgd", inplace: bool = False,
                        coef=None, **hyper):
    """The CUDA kernel over a group of leaves: ``[(new_param, *new_state)]``
    per leaf, each equal to :func:`fused_updater_step` of that leaf. The
    leaves share ``kind``, ``hyper``, ``lr``, ``step``, dtype and device;
    ``states[i]`` is leaf i's state in sorted-key order. One launch per
    :data:`TABLE_LEAVES` leaves (``fused_updater.launches``; the leaves on
    ``fused_updater.leaves``). ``inplace``: the new values overwrite the
    given (contiguous) parameter and state tensors, which are returned.
    CPU tensors take the plain version leaf by leaf."""
    if not params:
        return []
    if params[0].device.type == "cpu":
        outs = [fused_updater_step.fn(p, g, lr, step, *s, kind=kind, **hyper)
                for p, g, s in zip(params, grads, states)]
        if not inplace:
            return outs
        for p, s, out in zip(params, states, outs):
            for dst, new in zip((p,) + tuple(s), out):
                dst.copy_(new)
        return [(p,) + tuple(s) for p, s in zip(params, states)]
    upd, _, code = _resolve(kind, hyper, states[0])
    dev, dtype = params[0].device, params[0].dtype
    if dev.type != "cuda":
        raise ValueError(f"fused_updater: unsupported device {dev}")
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"fused_updater: dtype {dtype} not supported "
                         f"(float32, bfloat16 and float16 leaves)")
    ns = len(states[0])
    leaves = []
    for p, g, s in zip(params, grads, states):
        if len(s) != ns:
            raise ValueError(f"fused_updater[{kind}]: every leaf needs {ns} "
                             f"state arrays")
        if inplace and not all(t.is_contiguous() for t in (p,) + tuple(s)):
            raise ValueError("fused_updater: an in-place update needs "
                             "contiguous parameter and state tensors")
        bufs = [t.contiguous() for t in (p, g) + tuple(s)]
        if any(t.shape != p.shape or t.dtype != dtype or t.device != dev
               for t in bufs):
            raise ValueError("fused_updater: param, grad and state must "
                             "share shape, dtype and device (and one group "
                             "one dtype and device)")
        leaves.append(bufs)
    # the coefficients on the card (a no-op move when the trainer's lr and
    # step live there); kept alive until the launches are enqueued
    if coef is None:
        coef = upd.coefficients(_scalar(lr), step)
    coef = coef.to(dev, torch.float32).contiguous()
    if inplace:
        outs = [[b[0] for b in leaves]] + [[b[2 + j] for b in leaves]
                                           for j in range(ns)]
    else:
        outs = _flat_outputs([b[0].shape for b in leaves], dtype, dev,
                             1 + ns)
    es = leaves[0][0].element_size()
    rows = np.zeros((len(leaves), _ROW), np.int64)
    for i, bufs in enumerate(leaves):
        src = [t.data_ptr() for t in bufs]
        dst = [o[i].data_ptr() for o in outs]
        rows[i, :2 + ns] = src
        rows[i, 5:6 + ns] = dst
        n = bufs[0].numel()
        rows[i, 9] = n
        rows[i, 10] = vector_count(n, es, src + dst)
    fn = _build.kernel_fn("fused_updater", "dl4j_fused_updater_multi",
                          _ARGS)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for idx, starts in plan_launches(rows[:, 9].tolist(), es):
        table = np.ascontiguousarray(rows[idx])
        st = np.asarray(starts, np.int32)
        rc = fn(table.ctypes.data, st.ctypes.data, len(idx), code,
                _DTYPE_CODES[dtype], coef.data_ptr(), stream)
        if rc == -1:
            raise ValueError("fused_updater: unsupported dtype, kind or leaf "
                             "count")
        if rc != 0:
            raise RuntimeError(f"fused_updater: kernel launch failed with "
                               f"cudaError_t {rc}")
        fused_updater.launches += 1
    fused_updater.leaves += len(leaves)
    if inplace:
        from deeplearning4j_tpu_torch.ops.capture import bump_versions

        bump_versions([t for o in outs for t in o])
    return [tuple(o[i] for o in outs) for i in range(len(leaves))]


def fused_updater(param, grad, lr, step, *state, kind: str = "Sgd",
                  coef=None, **hyper):
    """The CUDA kernel of :func:`fused_updater_step` — same contract; a
    group of one leaf of :func:`fused_updater_multi`."""
    return fused_updater_multi([param], [grad], [tuple(state)], lr, step,
                               kind=kind, coef=coef, **hyper)[0]


fused_updater.launches = 0
fused_updater.leaves = 0


def fused_updater_usable(param, grad, lr, step, *state, **kw) -> bool:
    """Gate of the CUDA helper: the JAX ``_usable`` minus ``min_size`` —
    CUDA tensors, a floating leaf, equal shapes and the kind's number of
    state buffers."""
    ts = (param, grad) + state
    if not all(isinstance(t, torch.Tensor) and t.device.type == "cuda"
               for t in ts):
        return False
    if not param.is_floating_point():
        return False
    if any(t.shape != param.shape for t in ts):
        return False
    hyper = {k: v for k, v in kw.items() if k != "kind"}
    try:
        _, keys, _ = _updater_and_keys(kw.get("kind", "Sgd"),
                                       tuple(sorted(hyper.items())))
    except (ValueError, TypeError):
        return False
    return len(state) == len(keys)


def register_platform_fused_updater() -> None:
    """Install the kernel as the ``"cuda"`` helper of fused_updater_step."""
    from deeplearning4j_tpu_torch.ops.registry import registry

    reg = registry()
    if "cuda" not in reg.get("fused_updater_step").platform_impls:
        reg.register_platform("fused_updater_step", "cuda", fused_updater,
                              fused_updater_usable)
