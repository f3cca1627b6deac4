"""Each package of the port exports every public name of its JAX
counterpart, but for the names ROADMAP Queue 1 still owes, listed here
by name: a port of one of them must take it off this list, and a name
the port drops fails."""

import importlib

import pytest

PACKAGES = ("analysis", "autodiff", "datasets", "eval", "faults", "imports",
            "models", "nlp", "nn", "observe", "ops", "parallel", "rl",
            "serving")

# still to port: item 10 (breadth)
OWED = {
    "autodiff": {"UIListener"},
    "models": {"ModelHub"},
}


def _public(module):
    """``__all__``, or the public names that are not modules."""
    names = getattr(module, "__all__", None)
    if names is not None:
        return set(names)
    return {n for n in dir(module) if not n.startswith("_")
            and type(getattr(module, n)).__name__ != "module"}


@pytest.mark.parametrize("package", PACKAGES)
def test_port_exports_the_jax_names(package):
    jax_pkg = importlib.import_module(f"deeplearning4j_tpu.{package}")
    port = importlib.import_module(f"deeplearning4j_tpu_torch.{package}")
    exported = _public(port)
    assert all(hasattr(port, n) for n in exported), package
    assert _public(jax_pkg) - exported == OWED.get(package, set())
