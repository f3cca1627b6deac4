"""Abstract domain of the shape/dtype evidence — symbolic shapes, dtypes,
small constant values.

Counterpart of ``deeplearning4j_tpu/analysis/values.py``. The abstract
value of one graph tensor is an :class:`AVal`:

* ``shape`` — ``None`` (rank unknown) or a tuple whose entries are a
  non-negative ``int`` (concrete), a :class:`Dim` (named symbolic dim —
  every ``None``/``-1`` placeholder axis gets one, so ``(None, 128)``
  batches flow through matmuls and residual adds without losing the
  "these two batch dims are THE SAME dim" fact), or ``None`` (unknown).
* ``dtype`` — a ``torch.dtype`` or ``None`` (unknown). The JAX package
  keeps ``np.dtype``s; the port keeps torch's, which name bfloat16
  without a numpy extension. :func:`as_dtype` reads either spelling.
* ``value`` — a small concrete CPU tensor when the tensor is statically
  known (CONSTANT variables and the constant-env chains), for rules that
  branch on values (reshape targets).

The lattice is the usual "more ``None`` = less information"; every rule
must be *sound*: report an error only when the mismatch is provable from
concrete entries, degrade to unknown otherwise.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

# largest element count a const value is carried for — shape chains are
# tiny; big constants only need shape/dtype
CONST_VALUE_LIMIT = 4096

DimEntry = Union[int, "Dim", None]
Shape = Optional[Tuple[DimEntry, ...]]


def as_dtype(dt) -> torch.dtype:
    """A ``torch.dtype`` from a torch dtype, a numpy dtype or scalar type,
    or a dtype name (``"float32"``, ``"bfloat16"``, ``"bool"``); raises
    ``TypeError`` for anything else."""
    if isinstance(dt, torch.dtype):
        return dt
    if isinstance(dt, str):
        name = dt
    else:
        try:
            name = np.dtype(dt).name
        except TypeError:
            raise TypeError(f"not a dtype: {dt!r}") from None
    out = getattr(torch, "bool" if name == "bool_" else name, None)
    if not isinstance(out, torch.dtype):
        raise TypeError(f"not a dtype: {dt!r}")
    return out


class Dim:
    """A named symbolic dimension (batch/sequence axes declared None/-1)."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __repr__(self) -> str:
        return self.name

    def __eq__(self, other) -> bool:
        return isinstance(other, Dim) and other.name == self.name

    def __ne__(self, other) -> bool:
        return not self.__eq__(other)

    def __hash__(self) -> int:
        return hash(("Dim", self.name))


class AVal:
    """Abstract tensor value: symbolic shape + dtype + optional constant."""

    __slots__ = ("shape", "dtype", "value")

    def __init__(self, shape: Shape = None, dtype=None,
                 value: Optional[torch.Tensor] = None):
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = as_dtype(dtype) if dtype is not None else None
        self.value = value

    # ------------------------------------------------------------- factories
    @staticmethod
    def unknown() -> "AVal":
        return AVal()

    @staticmethod
    def of_array(arr, keep_value: bool = False) -> "AVal":
        """Abstract a tensor (any device) or an array; a kept value is
        copied to a CPU tensor — only small constants are kept, so a
        BERT-scale weight on the card is never copied to be abstracted."""
        shape = tuple(int(d) for d in np.shape(arr))
        dtype = getattr(arr, "dtype", None)
        if dtype is None:
            dtype = np.asarray(arr).dtype
        value = None
        if keep_value:
            n = 1
            for d in shape:
                n *= d
            if n <= CONST_VALUE_LIMIT:
                value = (arr.detach().cpu() if isinstance(arr, torch.Tensor)
                         else torch.as_tensor(np.asarray(arr)))
        return AVal(shape=shape, dtype=dtype, value=value)

    @staticmethod
    def of_placeholder(name: str, shape, dtype) -> "AVal":
        """Declared placeholder metadata → symbolic aval. ``None``/``-1``
        axes become named Dims so identical symbols unify downstream."""
        if shape is None:
            return AVal(dtype=dtype)
        sym = tuple(Dim(f"{name}.{i}") if d is None or int(d) < 0 else int(d)
                    for i, d in enumerate(shape))
        return AVal(shape=sym, dtype=dtype)

    # -------------------------------------------------------------- queries
    @property
    def rank(self) -> Optional[int]:
        return None if self.shape is None else len(self.shape)

    def is_concrete(self) -> bool:
        """Fully concrete shape (every entry an int)."""
        return self.shape is not None and all(
            isinstance(d, int) for d in self.shape)

    def concrete_shape(self) -> Optional[Tuple[int, ...]]:
        return tuple(self.shape) if self.is_concrete() else None  # type: ignore[arg-type]

    def num_elements(self) -> Optional[int]:
        s = self.concrete_shape()
        if s is None:
            return None
        n = 1
        for d in s:
            n *= d
        return n

    def __repr__(self) -> str:
        return f"AVal(shape={fmt_shape(self.shape)}, dtype={self.dtype})"


def fmt_shape(shape: Shape) -> str:
    if shape is None:
        return "?"
    return "(" + ", ".join("?" if d is None else str(d) for d in shape) + ")"


def dims_provably_unequal(a: DimEntry, b: DimEntry) -> bool:
    """True only when both entries are concrete ints and differ — the sound
    precondition for every error-severity shape finding."""
    return isinstance(a, int) and isinstance(b, int) and a != b


def dims_equal(a: DimEntry, b: DimEntry) -> bool:
    """Known-equal: same int, or same symbolic Dim."""
    if isinstance(a, int) and isinstance(b, int):
        return a == b
    if isinstance(a, Dim) and isinstance(b, Dim):
        return a == b
    return False
