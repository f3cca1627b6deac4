"""The zoo's Xception and InceptionResNetV1 of the PyTorch port against the JAX package
(CPU): ``output`` and two ``fit`` steps, as ``test_torch_zoo.py`` holds
them (``check_output_and_two_fit_steps``), in a file of its own so that
the test run's workers take the heavy models in parallel."""

import pytest

from test_torch_zoo import FIT_FILES, check_output_and_two_fit_steps


@pytest.mark.parametrize("name", FIT_FILES["test_torch_zoo_deep"])
def test_zoo_output_and_two_fit_steps_match_jax(name, monkeypatch):
    check_output_and_two_fit_steps(name, monkeypatch)
