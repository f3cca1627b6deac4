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
* :func:`fused_updater` launches ``csrc/fused_updater.cu`` (replacing
  ``_kernel``, ``pallas_updater.py:84``, via ``fused_updater_helper``):
  one pass reading param, grad and every state buffer once and writing
  the new param and state once, for all 11 kinds, in float32, bfloat16 or
  float16. Out of place: the wrapper allocates the outputs. Given CPU
  tensors it computes the plain version; given CUDA tensors it launches
  or raises. Its launches are counted in ``fused_updater.launches``.

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
from typing import Tuple

import torch

from deeplearning4j_tpu_torch.ops import _build
from deeplearning4j_tpu_torch.ops.registry import op

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_ARGS = (_P,) * 9 + (ctypes.c_longlong, _I, _I, _I) + (_F,) * 8 + (_P,)


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
    """lr as the float32 0-d CPU tensor the updater math takes."""
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


def fused_updater(param, grad, lr, step, *state, kind: str = "Sgd", **hyper):
    """The CUDA kernel of :func:`fused_updater_step` — same contract."""
    if param.device.type == "cpu":
        return fused_updater_step.fn(param, grad, lr, step, *state,
                                     kind=kind, **hyper)
    upd, _, code = _resolve(kind, hyper, state)
    if param.device.type != "cuda":
        raise ValueError(f"fused_updater: unsupported device {param.device}")
    if param.dtype not in _DTYPE_CODES:
        raise ValueError(f"fused_updater: dtype {param.dtype} not supported "
                         f"(float32, bfloat16 and float16 leaves)")
    bufs = [t.contiguous() for t in (param, grad) + tuple(state)]
    if any(t.shape != param.shape or t.dtype != param.dtype
           or t.device != param.device for t in bufs):
        raise ValueError("fused_updater: param, grad and state must share "
                         "shape, dtype and device")
    lr = _scalar(lr)
    coef = list(upd.coefficients(lr, step))
    coef += [0.0] * (8 - len(coef))
    outs = [torch.empty_like(bufs[0]) for _ in range(1 + len(state))]
    st_in = bufs[2:] + [None] * (3 - len(state))
    st_out = outs[1:] + [None] * (3 - len(state))

    def ptr(t):
        return None if t is None else t.data_ptr()

    fn = _build.kernel_fn("fused_updater", "dl4j_fused_updater", _ARGS)
    rc = fn(ptr(bufs[0]), ptr(bufs[1]), *map(ptr, st_in), ptr(outs[0]),
            *map(ptr, st_out), param.numel(), code, len(state),
            _DTYPE_CODES[param.dtype], *coef,
            torch.cuda.current_stream(param.device).cuda_stream)
    if rc == -1:
        raise ValueError("fused_updater: unsupported dtype, kind or state "
                         "count")
    if rc != 0:
        raise RuntimeError(f"fused_updater: kernel launch failed with "
                           f"cudaError_t {rc}")
    fused_updater.launches += 1
    return tuple(outs)


fused_updater.launches = 0


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
