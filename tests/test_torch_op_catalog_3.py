"""The port's op catalog against the JAX package's, on the CPU: run
3 of the parity cases (the ops by name, ``test_torch_op_catalog.py``
``parity_cases``), one case per (spec, dtype), in a file of its own so
that the test run's workers take the catalog in parallel."""

import pytest

from test_torch_op_catalog import check_op, parity_cases


@pytest.mark.parametrize("op,index,dtype", parity_cases(2))
def test_op_matches_the_jax_op(op, index, dtype):
    check_op(op, index, dtype)
