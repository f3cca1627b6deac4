"""Per-op validation table — the port's OpValidation ratchet.

Counterpart of ``deeplearning4j_tpu/ops/validation.py``. There a case is a
closure that runs the op and asserts against a numpy oracle; here a case is
a **spec** (:class:`Case`): the op name, its inputs drawn from a seeded
numpy ``RandomState``, its keyword arguments, the dtypes it takes and the
tolerance its result is held to. A spec runs anywhere, so one table serves
the CPU parity test against the JAX package (``tests/torch_parity.py``) and
the card-against-CPU run of chip_smoke's ``op_catalog`` phase
(:mod:`deeplearning4j_tpu_torch.testing.consistency`).

The ratchet: every name in the port's registry owns at least one case
(:func:`uncovered_ops` is empty), and there is no exemption list.

Conventions of a spec's inputs:

* numpy floating arrays are cast to the dtype under test (every one, or
  those at the positions ``cast`` names); integer and bool arrays keep
  their dtype (int64 becomes int32, as the JAX package runs with 64-bit
  types off);
* a list of arrays stays a list (``dynamic_stitch``, ``clip_by_global_norm``
  take lists or varargs);
* :class:`Key` stands for a random key: a ``jax.random.PRNGKey`` in the
  JAX package, a seeded ``torch.Generator`` on the op's device in the port;
* an op with no tensor input takes the device as the keyword ``device``,
  which the runners pass to the port's op alone (:func:`takes_device`).

A case whose ``check`` is set is held by that function (semantics: shape,
dtype, bounds, moments, factorizations) rather than value for value —
random draws, and the factorizations whose signs are free.
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

FLOAT = ("float32",)
HALF = ("float32", "bfloat16", "float16")

# Default tolerance of a 16-bit run: two units of the format, relative, and
# an absolute term of the same size for results near zero. Both packages
# compute a 16-bit op from 16-bit inputs; they differ in where they round
# an intermediate (once at the end, or after each step).
TOL16 = {"bfloat16": (2.0 ** -6, 2.0 ** -6), "float16": (2.0 ** -9, 2.0 ** -9)}


@dataclasses.dataclass(frozen=True)
class Key:
    """A random key argument, seeded with ``seed``."""

    seed: int = 0


@dataclasses.dataclass(frozen=True)
class Case:
    """One validation spec of ``op``.

    ``inputs(rs)`` returns the positional arguments, drawn from
    ``np.random.RandomState(seed)``; ``kwargs`` are passed as they are.
    ``rtol`` / ``atol`` hold float32 results; ``tol`` overrides the
    tolerance of a 16-bit dtype (default :data:`TOL16`). Integer and bool
    results are held exactly. ``grad``: the parity test also compares the
    gradients (float32). ``card_tol`` is the tolerance of the card against
    the CPU in a dtype where a kernel with its own stated bound takes the
    op. ``check(outputs, case, dtype)`` replaces the value
    comparison where results are free up to a sign or a draw; ``outputs``
    is the flat list of numpy results."""

    op: str
    inputs: Callable[[np.random.RandomState], Sequence[Any]]
    kwargs: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    dtypes: Tuple[str, ...] = FLOAT
    rtol: float = 1e-5
    atol: float = 1e-6
    tol: Mapping[str, Tuple[float, float]] = dataclasses.field(
        default_factory=dict)
    grad: bool = False
    seed: int = 0
    cast: Optional[Tuple[int, ...]] = None
    check: Optional[Callable[[List[np.ndarray], "Case", str], None]] = None
    label: str = ""
    card_tol: Mapping[str, Tuple[float, float]] = dataclasses.field(
        default_factory=dict)

    @property
    def name(self) -> str:
        return self.op + (f"[{self.label}]" if self.label else "")

    def tolerance(self, dtype: str) -> Tuple[float, float]:
        if dtype in self.tol:
            return self.tol[dtype]
        if dtype in TOL16:
            return TOL16[dtype]
        return self.rtol, self.atol

    def card_tolerance(self, dtype: str) -> Tuple[float, float]:
        return self.card_tol.get(dtype, self.tolerance(dtype))

    def draw(self) -> List[Any]:
        return list(self.inputs(np.random.RandomState(self.seed)))

    def casts(self, position: int) -> bool:
        return self.cast is None or position in self.cast


_CASES: Dict[str, List[Case]] = {}


def case(op_name: str, inputs: Callable, **fields: Any) -> Case:
    """Register a spec of ``op_name`` and return it."""
    c = Case(op_name, inputs, **fields)
    _CASES.setdefault(op_name, []).append(c)
    return c


def add_case(op_name: str, spec: Case) -> None:
    if spec.op != op_name:
        raise ValueError(f"spec of {spec.op!r} registered under {op_name!r}")
    _CASES.setdefault(op_name, []).append(spec)


def cases() -> Dict[str, List[Case]]:
    """All registered specs (op name -> list of specs)."""
    return _CASES


def uncovered_ops() -> List[str]:
    """Registered ops with no spec — the ratchet's red list."""
    from deeplearning4j_tpu_torch.ops.registry import registry

    return [n for n in registry().names() if not _CASES.get(n)]


def takes_device(fn: Callable) -> bool:
    """Whether an op's function takes the keyword ``device`` (the ops with
    no tensor input: fills, ranges, random draws)."""
    try:
        return "device" in inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return False


def flatten(out: Any) -> List[Any]:
    """The leaves of an op's result: tuples, lists and named tuples are
    walked in order."""
    if isinstance(out, (tuple, list)):
        leaves: List[Any] = []
        for o in out:
            leaves.extend(flatten(o))
        return leaves
    return [out]

