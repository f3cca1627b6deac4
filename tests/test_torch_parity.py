"""The shared parity harness (``tests/torch_parity.py``) catches what it is
for, on the CPU:

* a value one float32 unit in the last place beyond the tolerance, where
  the float32 just below it passes;
* a dtype that differs where the values agree (int64 for int32, int32
  where jnp promotes to float32), and a shape that differs;
* a gradient that differs where the forward agrees;
* 16-bit runs: a value one bfloat16 unit beyond two units fails;
* it pins ``torch.backends.cuda.matmul.allow_tf32`` off.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_parity

_X = np.random.RandomState(0).randn(4, 5).astype(np.float32)
RTOL, ATOL = 1e-5, 1e-6


def _edge_values(v: float):
    """The last float32 inside the band |a - v| <= ATOL + RTOL·|v| above
    ``v`` and the first one outside it."""
    edge = v + ATOL + RTOL * abs(v)
    out = np.float32(edge)
    if float(out) <= edge:
        out = np.nextafter(out, np.float32(np.inf))
    return np.nextafter(out, np.float32(-np.inf)), out


def _planted(value):
    def port(x):
        out = x.clone()
        out[1, 2] = float(value)
        return out

    return port


def test_a_value_one_ulp_beyond_the_tolerance_fails():
    inside, outside = _edge_values(float(_X[1, 2]))
    assert_parity(lambda x: x, _planted(inside), _X, rtol=RTOL, atol=ATOL)
    with pytest.raises(AssertionError):
        assert_parity(lambda x: x, _planted(outside), _X, rtol=RTOL,
                      atol=ATOL)


def test_a_dtype_mismatch_fails_where_values_agree():
    ints = np.asarray([[1, 2], [3, 4]], np.int32)
    with pytest.raises(AssertionError, match="dtype int64"):
        assert_parity(lambda a: jnp.prod(a, axis=1),
                      lambda a: torch.prod(a, dim=1), ints,
                      rtol=RTOL, atol=ATOL)
    with pytest.raises(AssertionError, match="dtype int32"):
        assert_parity(lambda a: jnp.minimum(jnp.maximum(a, 0), 6.0),
                      lambda a: torch.clamp(a, 0, 6), ints,
                      rtol=RTOL, atol=ATOL)


def test_a_shape_mismatch_fails():
    with pytest.raises(AssertionError, match="shape"):
        assert_parity(lambda a: jnp.sum(a, axis=1, keepdims=True),
                      lambda a: torch.sum(a, dim=1), _X,
                      rtol=RTOL, atol=ATOL)


def test_a_gradient_mismatch_fails_where_the_forward_agrees():
    def wrong_grad(x):
        # the forward is tanh(x); the gradient gets an extra 1e-3
        return torch.tanh(x) + 1e-3 * (x - x.detach())

    assert_parity(jnp.tanh, wrong_grad, _X, rtol=RTOL, atol=ATOL)
    with pytest.raises(AssertionError, match="gradient"):
        assert_parity(jnp.tanh, wrong_grad, _X, rtol=RTOL, atol=ATOL,
                      grad=True)
    assert_parity(jnp.tanh, torch.tanh, _X, rtol=RTOL, atol=ATOL, grad=True)


def test_16bit_runs_hold_two_units_and_fail_beyond():
    tol = {"bfloat16": (2.0 ** -6, 0.0)}

    def off_by(units):
        def port(x):
            out = torch.tanh(x)
            out[0, 0] = out[0, 0] * (1 + units * 2.0 ** -7)
            return out

        return port

    assert_parity(jnp.tanh, torch.tanh, _X, rtol=RTOL, atol=ATOL,
                  dtypes=("float32", "bfloat16", "float16"))
    assert_parity(jnp.tanh, off_by(1), _X, rtol=RTOL, atol=ATOL,
                  dtypes=("bfloat16",), tol=tol)
    with pytest.raises(AssertionError, match="bfloat16"):
        assert_parity(jnp.tanh, off_by(3), _X, rtol=RTOL, atol=ATOL,
                      dtypes=("bfloat16",), tol=tol)


def test_it_pins_tf32_off():
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        assert_parity(jnp.tanh, torch.tanh, _X, rtol=RTOL, atol=ATOL)
        assert torch.backends.cuda.matmul.allow_tf32 is False
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
