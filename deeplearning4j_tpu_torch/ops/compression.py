"""Threshold gradient compression of the port — the Strom-2015 codec.

Counterpart of ``deeplearning4j_tpu/ops/compression.py``: ``encode_threshold``
/ ``decode_threshold`` with their :class:`ThresholdEncoded` result and
``encode_bitmap`` / ``decode_bitmap``, under the same names. The encoded
form keeps the reference's static shapes: ``capacity`` index slots, −1
padded, and the count of valid entries as a 0-d tensor, so nothing is read
on the host.

Every op registers a validation spec (:mod:`.validation`).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.ops import validation as V
from deeplearning4j_tpu_torch.ops.registry import op


class ThresholdEncoded(NamedTuple):
    indices: torch.Tensor    # int32 [capacity], -1 padded
    signs: torch.Tensor      # int8 [capacity]
    count: torch.Tensor      # int32 scalar — number of valid entries
    threshold: torch.Tensor  # float32 scalar — the tau used


@op("encode_threshold")
def encode_threshold(grad, *, threshold: float,
                     capacity: int) -> Tuple[ThresholdEncoded, torch.Tensor]:
    """Sparse-encode entries with |g| > tau as (index, sign); the residual
    keeps the rest plus the sub-threshold remainder of encoded entries:
    decoded value ±tau, residual = g − decoded. Returns (encoded,
    residual); ``capacity`` bounds the encoded entries, and overflow stays
    in the residual."""
    flat = grad.reshape(-1)
    n = flat.shape[0]
    tau = torch.full((), threshold, dtype=flat.dtype, device=flat.device)
    mask = torch.abs(flat) > tau
    # every above-threshold entry first, in index order (stable)
    order = torch.argsort((~mask).to(torch.int8), stable=True)
    top = order[:capacity]
    valid = mask[top]
    count = mask.sum(dtype=torch.int32)
    kept = torch.clamp_max(count, capacity)
    sign = torch.sign(flat[top])
    zero = torch.zeros((), dtype=flat.dtype, device=flat.device)
    indices = torch.where(valid, top, -1).to(torch.int32)
    signs = torch.where(valid, sign, zero).to(torch.int8)
    decoded = torch.where(valid, sign * tau, zero)
    residual = flat.index_add(0, torch.where(valid, top, n - 1),
                              torch.where(valid, -decoded, zero))
    enc = ThresholdEncoded(indices=indices, signs=signs, count=kept,
                           threshold=tau.to(torch.float32))
    return enc, residual.reshape(grad.shape)


@op("decode_threshold")
def decode_threshold(encoded: ThresholdEncoded, *, shape) -> torch.Tensor:
    """Densify an encoded update: out[idx] += sign * tau (float32).
    ``encoded`` is a :class:`ThresholdEncoded` or its four fields in
    order."""
    encoded = ThresholdEncoded(*encoded)
    size = int(np.prod([int(s) for s in shape]))
    idx = encoded.indices.to(torch.int64)
    valid = idx >= 0
    vals = torch.where(valid, encoded.signs.to(torch.float32)
                       * encoded.threshold.to(torch.float32),
                       torch.zeros((), device=idx.device))
    out = torch.zeros(size, dtype=torch.float32, device=idx.device)
    out = out.index_add(0, torch.where(valid, idx, 0), vals)
    return out.reshape(tuple(int(s) for s in shape))


@op("encode_bitmap")
def encode_bitmap(grad, *, threshold: float):
    """Bitmap variant (reference encode_bitmap): a code per entry
    {0: below, 1: +tau, 2: -tau} as int8, and the residual."""
    tau = torch.full((), threshold, dtype=grad.dtype, device=grad.device)
    zero = torch.zeros((), dtype=grad.dtype, device=grad.device)
    code = torch.where(grad > tau, 1, torch.where(grad < -tau, 2, 0)
                       ).to(torch.int8)
    decoded = torch.where(code == 1, tau, torch.where(code == 2, -tau, zero))
    return code, grad - decoded


@op("decode_bitmap")
def decode_bitmap(code, *, threshold: float, dtype="float32"):
    from deeplearning4j_tpu_torch.analysis.values import as_dtype

    dt = as_dtype(dtype)
    tau = torch.full((), threshold, dtype=dt, device=code.device)
    zero = torch.zeros((), dtype=dt, device=code.device)
    return torch.where(code == 1, tau, torch.where(code == 2, -tau, zero))


# ---- validation specs -------------------------------------------------------


def _grad(r):
    return [(r.randn(5, 8) * 0.01).astype(np.float32)]


V.case("encode_threshold", _grad, kwargs={"threshold": 0.01,
                                          "capacity": 32},
       dtypes=("float32", "bfloat16"))
V.case("encode_threshold", _grad, kwargs={"threshold": 0.005,
                                          "capacity": 6}, label="overflow")


def _encoded(r):
    idx = np.asarray([3, 0, 9, -1, -1], np.int32)
    signs = np.asarray([1, -1, 1, 0, 0], np.int8)
    return [[idx, signs, np.asarray(3, np.int32),
             np.asarray(0.25, np.float32)]]


V.case("decode_threshold", _encoded, kwargs={"shape": (2, 5)})
V.case("encode_bitmap", _grad, kwargs={"threshold": 0.01},
       dtypes=V.HALF)
V.case("decode_bitmap", lambda r: [r.randint(0, 3, (4, 6)).astype(np.int8)],
       kwargs={"threshold": 0.5})
V.case("decode_bitmap", lambda r: [r.randint(0, 3, (4, 6)).astype(np.int8)],
       kwargs={"threshold": 0.5, "dtype": "bfloat16"}, label="bfloat16")
