"""Bitwise and integer ops of the port.

Counterpart of ``deeplearning4j_tpu/ops/bitwise.py``, under the same
names, on 32-bit lanes. Torch's ``>>`` on int32 is arithmetic and it has
no unsigned 32-bit shifts or popcount on every device, so the cyclic
shifts run on the lanes' unsigned values held in int64 and masked back to
32 bits, and ``bits_hamming_distance`` counts bits with the SWAR
(shift-and-mask) sum. A shift of 32 or more gives what XLA gives: 0 for a
left shift, the sign for an arithmetic right shift.

Every op registers a validation spec (:mod:`.validation`).
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.ops import validation as V
from deeplearning4j_tpu_torch.ops.registry import op

_MASK32 = 0xFFFFFFFF


def _unsigned(x):
    """The 32-bit lanes of ``x`` as their unsigned values, in int64."""
    return x.to(torch.int64) & _MASK32


def _signed(u, dtype):
    """Unsigned 32-bit values (int64) back to a 32-bit signed lane."""
    u = u & _MASK32
    return torch.where(u >= 2 ** 31, u - 2 ** 32, u).to(dtype)


@op("bitwise_and")
def bitwise_and(x, y):
    """bitwise and (generic/bitwise/and.cpp)."""
    return torch.bitwise_and(x, y)


@op("bitwise_or")
def bitwise_or(x, y):
    """bitwise or (generic/bitwise/or.cpp)."""
    return torch.bitwise_or(x, y)


@op("bitwise_xor")
def bitwise_xor(x, y):
    """bitwise xor (generic/bitwise/xor.cpp)."""
    return torch.bitwise_xor(x, y)


@op("toggle_bits")
def toggle_bits(x):
    """bitwise not (generic/bitwise/toggle_bits.cpp)."""
    return torch.bitwise_not(x)


@op("shift_bits")
def shift_bits(x, *, shift: int):
    """left shift (generic/bitwise/shift.cpp)."""
    if shift >= 32:
        return torch.zeros_like(x)
    return _signed(_unsigned(x) << shift, x.dtype)


@op("rshift_bits")
def rshift_bits(x, *, shift: int):
    """arithmetic right shift (generic/bitwise/shift.cpp)."""
    return x >> min(int(shift), 31)


@op("cyclic_shift_bits")
def cyclic_shift_bits(x, *, shift: int):
    """cyclic (rotate) left shift on 32-bit lanes
    (generic/bitwise/cyclic_shift.cpp)."""
    u = _unsigned(x)
    hi = (u << shift) if shift < 32 else torch.zeros_like(u)
    lo = (u >> (32 - shift)) if shift > 0 else torch.zeros_like(u)
    return _signed(hi | lo, x.dtype)


@op("cyclic_rshift_bits")
def cyclic_rshift_bits(x, *, shift: int):
    """cyclic right shift on 32-bit lanes (generic/bitwise/cyclic_shift.cpp)."""
    u = _unsigned(x)
    lo = (u >> shift) if shift < 32 else torch.zeros_like(u)
    hi = (u << (32 - shift)) if shift > 0 else torch.zeros_like(u)
    return _signed(hi | lo, x.dtype)


def popcount32(u):
    """Set bits of each unsigned 32-bit value (held in int64)."""
    u = u - ((u >> 1) & 0x55555555)
    u = (u & 0x33333333) + ((u >> 2) & 0x33333333)
    u = (u + (u >> 4)) & 0x0F0F0F0F
    return ((u * 0x01010101) & _MASK32) >> 24


@op("bits_hamming_distance")
def bits_hamming_distance(x, y):
    """total popcount of x^y, int32 (generic/bitwise/bits_hamming_distance.cpp)."""
    return torch.sum(popcount32(_unsigned(torch.bitwise_xor(x, y))),
                     dtype=torch.int32)


# ---- validation specs -------------------------------------------------------


def _ints(r):
    return [r.randint(-(1 << 31), (1 << 31) - 1, (4, 9)).astype(np.int32),
            r.randint(-(1 << 31), (1 << 31) - 1, (4, 9)).astype(np.int32)]


for _name in ("bitwise_and", "bitwise_or", "bitwise_xor",
              "bits_hamming_distance"):
    V.case(_name, _ints)
V.case("bits_hamming_distance", lambda r: [
    np.asarray([0b1010, 0b1111, -1, 0], np.int32),
    np.asarray([0b0011, 0b1111, 0, -2 ** 31], np.int32)], label="edges")
V.case("toggle_bits", lambda r: _ints(r)[:1])
for _name in ("shift_bits", "rshift_bits", "cyclic_shift_bits",
              "cyclic_rshift_bits"):
    for _s in (0, 1, 7, 31):
        V.case(_name, lambda r: _ints(r)[:1], kwargs={"shift": _s},
               label=f"shift={_s}")
