"""Weight initialization — DL4J's WeightInit schemes.

Counterpart of ``deeplearning4j_tpu/ops/weight_init.py``: the same schemes
and fan-in/fan-out rules, drawing from an explicit ``torch.Generator``
instead of a ``jax.random`` key. The two streams differ, so a parity test
carries the JAX package's parameters across instead of re-seeding.

Draws happen on the generator's device (the CPU unless the caller passes a
CUDA generator) and the result is moved to ``device``: the same seed gives
the same weights whichever card the network lives on.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import torch

Device = Union[str, torch.device, None]


def _fans(shape: Sequence[int]) -> Tuple[float, float]:
    if len(shape) == 1:
        return float(shape[0]), float(shape[0])
    if len(shape) == 2:
        return float(shape[0]), float(shape[1])
    receptive = 1
    for s in shape[:-2]:
        receptive *= s
    return float(receptive * shape[-2]), float(receptive * shape[-1])


def _normal(gen, shape):
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=gen.device)


def _uniform(gen, shape, lo, hi):
    u = torch.rand(shape, generator=gen, dtype=torch.float32,
                   device=gen.device)
    return lo + (hi - lo) * u


def init_weights(gen: torch.Generator, shape, scheme: str = "xavier", *,
                 dtype: torch.dtype = torch.float32, device: Device = None,
                 gain: float = 1.0) -> torch.Tensor:
    """Initialize a tensor per a WeightInit scheme name (the
    ``"distribution"`` scheme, which takes a distribution spec, is not
    ported: no ported layer config carries one)."""
    scheme = str(scheme).lower()
    shape = tuple(int(s) for s in shape)
    fan_in, fan_out = _fans(shape)

    def done(t):
        return t.to(device=device if device is not None else t.device,
                    dtype=dtype)

    if scheme == "zero":
        return torch.zeros(shape, dtype=dtype, device=device)
    if scheme == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    if scheme == "identity":
        if len(shape) != 2 or shape[0] != shape[1]:
            raise ValueError("identity init requires square 2-D shape")
        return torch.eye(shape[0], dtype=dtype, device=device)
    if scheme in ("normal", "xavier_fan_in", "lecun_normal"):
        # reference NORMAL: N(0, 1/sqrt(fanIn))
        return done(_normal(gen, shape) / math.sqrt(fan_in))
    if scheme == "uniform":
        a = 1.0 / math.sqrt(fan_in)
        return done(_uniform(gen, shape, -a, a))
    if scheme == "xavier":
        # reference XAVIER: N(0, 2/(fanIn+fanOut))
        return done(math.sqrt(2.0 / (fan_in + fan_out)) * _normal(gen, shape))
    if scheme == "xavier_uniform":
        a = math.sqrt(6.0 / (fan_in + fan_out))
        return done(_uniform(gen, shape, -a, a))
    if scheme == "xavier_legacy":
        return done(math.sqrt(1.0 / (fan_in + fan_out)) * _normal(gen, shape))
    if scheme == "relu":
        # He init: N(0, 2/fanIn)
        return done(math.sqrt(2.0 / fan_in) * _normal(gen, shape))
    if scheme == "relu_uniform":
        a = math.sqrt(6.0 / fan_in)
        return done(_uniform(gen, shape, -a, a))
    if scheme == "sigmoid_uniform":
        a = 4.0 * math.sqrt(6.0 / (fan_in + fan_out))
        return done(_uniform(gen, shape, -a, a))
    if scheme == "lecun_uniform":
        a = math.sqrt(3.0 / fan_in)
        return done(_uniform(gen, shape, -a, a))
    fans = {"fan_in": fan_in, "fan_out": fan_out,
            "fan_avg": (fan_in + fan_out) / 2}
    for kind in ("normal", "uniform"):
        for name, fan in fans.items():
            if scheme != f"var_scaling_{kind}_{name}":
                continue
            if kind == "normal":
                return done(gain * _normal(gen, shape) / math.sqrt(fan))
            a = gain * math.sqrt(3.0 / fan)
            return done(_uniform(gen, shape, -a, a))
    raise ValueError(f"unknown weight init scheme '{scheme}'")

