"""Symbolic NumPy-style broadcasting and the JAX package's dtype promotion.

Counterpart of ``deeplearning4j_tpu/analysis/broadcast.py``. Soundness
contract (shared with every rule in ``rules.py``): a broadcast *error* is
reported only when two aligned entries are both concrete ints, neither is
1, and they differ. Symbolic/unknown entries degrade the result dim, never
produce an error — a ``(None, 128)`` batch against a concrete ``(4, 128)``
activation must check clean.

Promotion is the JAX package's (``jnp.promote_types``), written out as a
table: the optimizer's matchers and its invariant checker read these
dtypes, and the port must decide exactly as the JAX package does. Torch's
own promotion differs (``uint32 + int8``, ``uint64 + int64``); a test holds
the table to ``jnp.promote_types`` pair by pair.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from deeplearning4j_tpu_torch.analysis.values import DimEntry, Dim, Shape, fmt_shape


class BroadcastError(Exception):
    """Provable broadcast failure; ``.detail`` names the offending axis."""

    def __init__(self, detail: str):
        super().__init__(detail)
        self.detail = detail


def broadcast_dim(a: DimEntry, b: DimEntry) -> DimEntry:
    """One aligned axis pair → result entry (raises on provable failure)."""
    if isinstance(a, int) and isinstance(b, int):
        if a == b:
            return a
        if a == 1:
            return b
        if b == 1:
            return a
        raise BroadcastError(f"{a} vs {b}")
    if a is None or b is None:
        # unknown vs concrete>1 → the concrete dim (any valid execution
        # yields it); unknown vs 1 or unknown vs symbol → unknown
        other = a if b is None else b
        if isinstance(other, int) and other > 1:
            return other
        return None
    # at least one symbolic Dim
    if isinstance(a, Dim) and isinstance(b, Dim):
        return a if a == b else None
    sym, conc = (a, b) if isinstance(a, Dim) else (b, a)
    if isinstance(conc, int):
        if conc == 1:
            return sym
        return conc  # symbol must equal the concrete dim in a valid run
    return None


def broadcast_shapes(shapes: Sequence[Shape]) -> Shape:
    """NumPy-style broadcast of N symbolic shapes (right-aligned).

    Raises :class:`BroadcastError` only on a provable mismatch; any shape
    with unknown rank makes the whole result unknown."""
    known = [s for s in shapes if s is not None]
    if len(known) != len(shapes) or not known:
        return None
    rank = max(len(s) for s in known)
    out: List[DimEntry] = []
    for axis in range(rank):
        entry: DimEntry = 1
        for s in known:
            idx = len(s) - rank + axis
            d = s[idx] if idx >= 0 else 1
            try:
                entry = broadcast_dim(entry, d)
            except BroadcastError:
                raise BroadcastError(
                    f"axis {axis - rank}: "
                    + " vs ".join(fmt_shape(s) for s in known))
        out.append(entry)
    return tuple(out)


# jnp.promote_types over the dtypes both frameworks name: row ⊔ column
_ORDER = ("bool", "uint8", "uint16", "uint32", "uint64", "int8", "int16",
          "int32", "int64", "bfloat16", "float16", "float32", "float64",
          "complex64", "complex128")
_ROWS = """
bool uint8 uint16 uint32 uint64 int8 int16 int32 int64 bfloat16 float16 float32 float64 complex64 complex128
uint8 uint8 uint16 uint32 uint64 int16 int16 int32 int64 bfloat16 float16 float32 float64 complex64 complex128
uint16 uint16 uint16 uint32 uint64 int32 int32 int32 int64 bfloat16 float16 float32 float64 complex64 complex128
uint32 uint32 uint32 uint32 uint64 int32 int32 int32 int64 bfloat16 float16 float32 float64 complex64 complex128
uint64 uint64 uint64 uint64 uint64 float64 float64 float64 float64 bfloat16 float16 float32 float64 complex64 complex128
int8 int16 int32 int32 float64 int8 int16 int32 int64 bfloat16 float16 float32 float64 complex64 complex128
int16 int16 int32 int32 float64 int16 int16 int32 int64 bfloat16 float16 float32 float64 complex64 complex128
int32 int32 int32 int32 float64 int32 int32 int32 int64 bfloat16 float16 float32 float64 complex64 complex128
int64 int64 int64 int64 float64 int64 int64 int64 int64 bfloat16 float16 float32 float64 complex64 complex128
bfloat16 bfloat16 bfloat16 bfloat16 bfloat16 bfloat16 bfloat16 bfloat16 bfloat16 bfloat16 float32 float32 float64 complex64 complex128
float16 float16 float16 float16 float16 float16 float16 float16 float16 float32 float16 float32 float64 complex64 complex128
float32 float32 float32 float32 float32 float32 float32 float32 float32 float32 float32 float32 float64 complex64 complex128
float64 float64 float64 float64 float64 float64 float64 float64 float64 float64 float64 float64 float64 complex128 complex128
complex64 complex64 complex64 complex64 complex64 complex64 complex64 complex64 complex64 complex64 complex64 complex64 complex128 complex64 complex128
complex128 complex128 complex128 complex128 complex128 complex128 complex128 complex128 complex128 complex128 complex128 complex128 complex128 complex128 complex128
"""


def _table() -> Dict[Tuple[torch.dtype, torch.dtype], torch.dtype]:
    out = {}
    for a, row in zip(_ORDER, _ROWS.split("\n")[1:]):
        for b, r in zip(_ORDER, row.split()):
            dt_a, dt_b, dt_r = (getattr(torch, n, None) for n in (a, b, r))
            if None not in (dt_a, dt_b, dt_r):  # torch builds without uint*
                out[(dt_a, dt_b)] = dt_r
    return out


_PROMOTE = _table()


def promote_types(a: torch.dtype, b: torch.dtype) -> torch.dtype:
    """``jnp.promote_types(a, b)`` on torch dtypes (torch's own promotion
    for a pair outside the table, e.g. float8)."""
    out = _PROMOTE.get((a, b))
    return out if out is not None else torch.promote_types(a, b)


def promote_dtypes(dtypes: Sequence[Optional[torch.dtype]]
                   ) -> Optional[torch.dtype]:
    """The JAX promotion lattice over known dtypes; None if any is
    unknown."""
    if any(dt is None for dt in dtypes) or not dtypes:
        return None
    out = dtypes[0]
    for dt in dtypes[1:]:
        out = promote_types(out, dt)
    return out


def is_float_dtype(dt: Optional[torch.dtype]) -> bool:
    """Floating point, bfloat16 and float8 included, or complex (numpy's
    ``inexact``)."""
    return dt is not None and (dt.is_floating_point or dt.is_complex)


def is_int_dtype(dt: Optional[torch.dtype]) -> bool:
    """Signed or unsigned integer (not bool)."""
    return (dt is not None and dt != torch.bool
            and not dt.is_floating_point and not dt.is_complex)


def promotion_surprise(dtypes: Sequence[Optional[torch.dtype]]
                       ) -> Optional[str]:
    """The GC003 predicate: mixed float widths (bf16+f32, f32+f64), or a
    promotion to a dtype wider than every input (int32+uint32→int64).
    Returns a human-readable reason, or None when unsurprising."""
    known = [dt for dt in dtypes if dt is not None]
    if len(known) < 2:
        return None
    inexact = [dt for dt in known if is_float_dtype(dt)]
    if len(inexact) >= 2 and len(set(inexact)) > 1:
        names = sorted({str(dt).replace("torch.", "") for dt in inexact})
        return f"mixed float widths {' vs '.join(names)}"
    promoted = promote_dtypes(known)
    if promoted is not None and all(promoted != dt for dt in known):
        names = " + ".join(str(dt).replace("torch.", "") for dt in known)
        return (f"{names} promotes to {str(promoted).replace('torch.', '')}"
                f" (wider than every input)")
    return None
