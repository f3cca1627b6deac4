"""RNG and distribution ops of the port.

Counterpart of ``deeplearning4j_tpu/ops/random.py``: ``RandomSource`` and
the six draws, under the same names and keywords. The JAX package's key
argument is here an explicit ``torch.Generator`` on the draw's device, as
the port's dropout takes one, or an int seed, from which each call seeds a
fresh generator on ``device`` — the same seed gives the same draw on one
device, as a JAX key does. The streams are torch's, not JAX's: the two
packages agree in distribution, not value for value.

``random_truncated_normal`` truncates at ±2σ (``random.py:75``) by the
inverse CDF of a uniform draw between Φ(−2) and Φ(2).

Every op registers a validation spec (:mod:`.validation`) held by
semantics: shape, dtype, bounds, moments within stated bounds, and the same
seed giving the same draw.
"""

from __future__ import annotations

import math
from typing import Sequence, Union

import numpy as np
import torch

from deeplearning4j_tpu_torch.environment import resolve_device
from deeplearning4j_tpu_torch.ops import validation as V
from deeplearning4j_tpu_torch.ops.registry import op
from deeplearning4j_tpu_torch.ops.validation import Key

KeyLike = Union[torch.Generator, int]


def generator(key: KeyLike, device=None) -> torch.Generator:
    """``key`` as a generator: itself, or a fresh one seeded with the int
    ``key`` on ``device`` (the card unless the caller asks for the CPU)."""
    if isinstance(key, torch.Generator):
        return key
    return torch.Generator(device=resolve_device(device)).manual_seed(
        int(key))


class RandomSource:
    """Stateful generator dispenser (Nd4j.getRandom() analog): each
    :meth:`next_key` is a new generator on ``device`` seeded from one
    stream of seeds, so a run with the same seed hands out the same
    generators in the same order."""

    def __init__(self, seed: int = 0, device=None):
        self._device = device
        self.set_seed(seed)

    def set_seed(self, seed: int) -> None:
        self._seed = int(seed)
        self._seeds = np.random.SeedSequence(self._seed)

    def next_key(self) -> torch.Generator:
        return self.split(1)[0]

    def split(self, n: int):
        children = self._seeds.spawn(n)
        return [generator(int(c.generate_state(1, np.uint64)[0] >> 1),
                          self._device) for c in children]


_DEFAULT = None


def default_rng() -> RandomSource:
    """The process-wide source (seed 123, as the reference's), made on
    first use so importing the package touches no device."""
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = RandomSource(123)
    return _DEFAULT


def _draw_setup(key, shape, dtype, device):
    from deeplearning4j_tpu_torch.analysis.values import as_dtype

    g = generator(key, device)
    return g, tuple(int(s) for s in shape), as_dtype(dtype), g.device


@op("random_uniform")
def random_uniform(key, *, shape: Sequence[int], minval: float = 0.0,
                   maxval: float = 1.0, dtype="float32", device=None):
    g, shape, dt, dev = _draw_setup(key, shape, dtype, device)
    u = torch.rand(shape, generator=g, device=dev, dtype=torch.float32)
    return (minval + (maxval - minval) * u).to(dt)


@op("random_normal")
def random_normal(key, *, shape: Sequence[int], mean: float = 0.0,
                  stddev: float = 1.0, dtype="float32", device=None):
    g, shape, dt, dev = _draw_setup(key, shape, dtype, device)
    z = torch.randn(shape, generator=g, device=dev, dtype=torch.float32)
    return (mean + stddev * z).to(dt)


_PHI_M2 = 0.5 * math.erfc(2.0 / math.sqrt(2.0))  # Φ(−2)


@op("random_truncated_normal")
def random_truncated_normal(key, *, shape: Sequence[int], mean: float = 0.0,
                            stddev: float = 1.0, dtype="float32",
                            device=None):
    g, shape, dt, dev = _draw_setup(key, shape, dtype, device)
    u = torch.rand(shape, generator=g, device=dev, dtype=torch.float64)
    z = torch.special.ndtri(_PHI_M2 + (1.0 - 2.0 * _PHI_M2) * u)
    z = torch.clamp(z, -2.0, 2.0).to(torch.float32)
    return (mean + stddev * z).to(dt)


@op("random_bernoulli")
def random_bernoulli(key, *, shape: Sequence[int], prob: float = 0.5,
                     dtype="float32", device=None):
    g, shape, dt, dev = _draw_setup(key, shape, dtype, device)
    u = torch.rand(shape, generator=g, device=dev, dtype=torch.float32)
    return (u < prob).to(dt)


@op("random_gamma")
def random_gamma(key, *, shape: Sequence[int], alpha: float = 1.0,
                 beta: float = 1.0, dtype="float32", device=None):
    g, shape, dt, dev = _draw_setup(key, shape, dtype, device)
    a = torch.full(shape, float(alpha), dtype=torch.float32, device=dev)
    return (torch._standard_gamma(a, generator=g) / beta).to(dt)


@op("random_exponential")
def random_exponential(key, *, shape: Sequence[int], rate: float = 1.0,
                       dtype="float32", device=None):
    g, shape, dt, dev = _draw_setup(key, shape, dtype, device)
    e = torch.empty(shape, dtype=torch.float32, device=dev).exponential_(
        1.0, generator=g)
    return (e / rate).to(dt)


# ---- validation specs (semantics) -----------------------------------------

_N = (64, 64)  # 4096 draws: a sample mean within 0.1σ is ~6 standard errors


def _moments(mean, std, lo=-np.inf, hi=np.inf, tol=0.1):
    """A check of one draw: inside [lo, hi], mean within ``tol``·σ of
    ``mean`` and standard deviation within ``tol`` relative of ``std``."""

    def check(outs, spec, dtype):
        y = np.asarray(outs[0], np.float64)
        assert y.shape == tuple(spec.kwargs["shape"]), y.shape
        assert np.isfinite(y).all()
        assert (y >= lo).all() and (y <= hi).all(), (y.min(), y.max())
        assert abs(y.mean() - mean) <= tol * std, (y.mean(), mean)
        assert abs(y.std() - std) <= tol * std, (y.std(), std)

    return check


_B = 1.0 - 2.0 * _PHI_M2  # mass of N(0, 1) inside ±2
_TN_STD = math.sqrt(1.0 - 4.0 * math.exp(-2.0) / math.sqrt(2 * math.pi) / _B)

V.case("random_uniform", lambda r: [Key(1)],
       kwargs={"shape": _N, "minval": -1.0, "maxval": 3.0},
       dtypes=V.FLOAT, check=_moments(1.0, 4 / math.sqrt(12), -1.0, 3.0))
V.case("random_normal", lambda r: [Key(2)],
       kwargs={"shape": _N, "mean": 0.5, "stddev": 2.0},
       check=_moments(0.5, 2.0))
V.case("random_truncated_normal", lambda r: [Key(3)],
       kwargs={"shape": _N, "mean": 1.0, "stddev": 0.5},
       check=_moments(1.0, 0.5 * _TN_STD, 0.0, 2.0))
V.case("random_bernoulli", lambda r: [Key(4)],
       kwargs={"shape": _N, "prob": 0.3},
       check=_moments(0.3, math.sqrt(0.21), 0.0, 1.0))
V.case("random_gamma", lambda r: [Key(5)],
       kwargs={"shape": _N, "alpha": 3.0, "beta": 2.0},
       check=_moments(1.5, math.sqrt(3.0) / 2.0, 0.0))
V.case("random_exponential", lambda r: [Key(6)],
       kwargs={"shape": _N, "rate": 4.0},
       check=_moments(0.25, 0.25, 0.0))


def _bounds(lo, hi):
    def check(outs, spec, dtype):
        y = np.asarray(outs[0], np.float64)
        assert y.shape == tuple(spec.kwargs["shape"]), y.shape
        assert (y >= lo).all() and (y <= hi).all(), (y.min(), y.max())

    return check


V.case("random_uniform", lambda r: [Key(7)],
       kwargs={"shape": (8, 8), "dtype": "bfloat16"}, check=_bounds(0.0, 1.0),
       label="bfloat16")
