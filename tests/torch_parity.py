"""Shared parity harness of the port's tests: one op, two packages.

``assert_parity(ref_fn, port_fn, *np_inputs, rtol, atol, grad=False,
dtypes=("float32",))`` runs the JAX package's function and the port's on
the same numpy arrays, in each dtype asked for, and holds the port to the
reference:

* the results have the same structure (tuples, lists and named tuples are
  walked in order), and each leaf the same shape and the same dtype — a
  port that returns int64 where jnp gives int32, or int32 where jnp
  promotes to float32, fails here even when the values agree;
* floating leaves agree within ``rtol`` / ``atol`` (NaN where the reference
  has NaN); integer and bool leaves are equal;
* with ``grad=True`` (float32 only) the vector-Jacobian products agree:
  ``jax.vjp`` against ``torch.autograd.grad`` with one seeded cotangent a
  floating result, with respect to every floating input.

Inputs follow the conventions of the port's validation specs
(``deeplearning4j_tpu_torch/ops/validation.py``), keyword arrays as well
as positional ones: floating arrays are cast
to the dtype under test (all of them, or the positions in ``cast``) by way
of float32 in both packages, so both round the same values; int64 becomes
int32; a list stays a list; a ``validation.Key`` becomes a
``jax.random.PRNGKey`` and a seeded ``torch.Generator``. ``kwargs`` go to
both functions, ``port_kwargs`` to the port's alone (its ``device``).

TF32 is pinned off for every float32 product the port makes on a card
(``torch.backends.cuda.matmul.allow_tf32 = False``), as the reference
computes float32 products in float32.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import torch

from deeplearning4j_tpu_torch.ops.validation import Key, flatten
from deeplearning4j_tpu_torch.testing.consistency import leaf, to_device

torch.backends.cuda.matmul.allow_tf32 = False

_NP16 = {"bfloat16": ml_dtypes.bfloat16, "float16": np.float16,
         "float32": np.float32}


def _is_float_array(v) -> bool:
    return isinstance(v, np.ndarray) and v.dtype.kind == "f"


def _canon_int(v: np.ndarray) -> np.ndarray:
    if v.dtype == np.int64:
        return v.astype(np.int32)
    if v.dtype == np.uint64:
        return v.astype(np.uint32)
    return v


def to_jax(v, dtype: str, castable: bool = True):
    if isinstance(v, list):
        return [to_jax(x, dtype, castable) for x in v]
    if isinstance(v, Key):
        return jax.random.PRNGKey(v.seed)
    if _is_float_array(v):
        a = v.astype(np.float32)
        return jnp.asarray(a.astype(_NP16[dtype]) if castable else a)
    if isinstance(v, np.ndarray):
        return jnp.asarray(_canon_int(v))
    return v


def to_torch(v, dtype: str, castable: bool = True, device: str = "cpu"):
    return to_device(v, dtype, castable, device)


def leaves(out) -> List[Tuple[np.ndarray, str]]:
    return [leaf(x) for x in flatten(out)]


def _float_name(name: str) -> bool:
    return name in ("float16", "bfloat16", "float32", "float64")


def compare_leaves(got: List[Tuple[np.ndarray, str]],
                   want: List[Tuple[np.ndarray, str]],
                   rtol: float, atol: float, what: str = "result",
                   values: bool = True) -> None:
    assert len(got) == len(want), (
        f"{what}: the port gives {len(got)} leaves, the reference "
        f"{len(want)}")
    for i, ((g, gd), (w, wd)) in enumerate(zip(got, want)):
        assert gd == wd, f"{what} leaf {i}: dtype {gd}, reference {wd}"
        assert g.shape == w.shape, (
            f"{what} leaf {i}: shape {g.shape}, reference {w.shape}")
        if not values:
            continue
        if _float_name(wd):
            np.testing.assert_allclose(
                g.astype(np.float64), w.astype(np.float64), rtol=rtol,
                atol=atol, equal_nan=True, err_msg=f"{what} leaf {i}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{what} leaf {i}")


def _run_grads(ref_fn, port_fn, inputs, kwargs, port_kwargs, cast,
               rtol, atol) -> None:
    pos = [i for i, v in enumerate(inputs)
           if _is_float_array(v) and (cast is None or i in cast)]
    if not pos:
        return
    jargs = [to_jax(v, "float32") for v in inputs]
    targs = [to_torch(v, "float32") for v in inputs]

    def jf(*fa):
        args = list(jargs)
        for i, a in zip(pos, fa):
            args[i] = a
        outs = flatten(ref_fn(*args, **jkw))
        return tuple(o for o in outs if jnp.issubdtype(o.dtype, jnp.floating))

    jkw = {k: to_jax(v, "float32") for k, v in kwargs.items()}
    tkw = {k: to_torch(v, "float32") for k, v in kwargs.items()}
    outs, vjp = jax.vjp(jax.jit(jf), *[jargs[i] for i in pos])
    rs = np.random.RandomState(7)
    cots = [np.asarray(rs.randn(*np.shape(o)), np.float32) for o in outs]
    jgrads = vjp(tuple(jnp.asarray(c) for c in cots))

    for i in pos:
        targs[i] = targs[i].clone().requires_grad_(True)
    with torch.enable_grad():
        touts = [o for o in flatten(port_fn(*targs, **tkw, **port_kwargs))
                 if o.is_floating_point()]
        assert len(touts) == len(cots), "floating results differ in number"
        # a result cut from the graph (stop_gradient) contributes zeros
        live = [(o, torch.from_numpy(c)) for o, c in zip(touts, cots)
                if o.requires_grad]
        tgrads = (torch.autograd.grad(
            [o for o, _ in live], [targs[i] for i in pos],
            [c for _, c in live], allow_unused=True) if live
            else [None] * len(pos))
    got = [(leaf(g)[0] if g is not None else
            np.zeros(np.shape(targs[i]), np.float32), "float32")
           for g, i in zip(tgrads, pos)]
    want = [(np.asarray(g), "float32") for g in jgrads]
    compare_leaves(got, want, rtol, atol, what="gradient")


def _reference(ref_fn, jargs, jkw, dtype: str):
    """The reference's result. In float32 the function is compiled whole
    (one XLA program, where the eager path compiles every primitive apart:
    the same float32 arithmetic, in a fraction of the time); a function
    that needs concrete values (a shape read from an operand) runs
    eagerly. 16-bit runs stay eager, so each op rounds to the 16-bit type
    as the port's ops do (a compiled program keeps float32 between fused
    ops)."""
    if dtype == "float32":
        try:
            return jax.jit(lambda *a: ref_fn(*a, **jkw))(*jargs)
        except (jax.errors.ConcretizationTypeError,
                jax.errors.TracerArrayConversionError,
                jax.errors.TracerIntegerConversionError,
                NotImplementedError):
            pass
    return ref_fn(*jargs, **jkw)


def assert_parity(ref_fn: Callable, port_fn: Callable, *np_inputs: Any,
                  rtol: float, atol: float, grad: bool = False,
                  dtypes: Sequence[str] = ("float32",),
                  kwargs: Optional[Mapping[str, Any]] = None,
                  port_kwargs: Optional[Mapping[str, Any]] = None,
                  tol: Optional[Mapping[str, Tuple[float, float]]] = None,
                  cast: Optional[Sequence[int]] = None,
                  check: Optional[Callable[[List[np.ndarray], str], None]]
                  = None) -> None:
    """Hold ``port_fn`` to ``ref_fn`` on ``np_inputs`` in every dtype of
    ``dtypes`` (``tol[dtype]`` overrides ``(rtol, atol)`` for a dtype).
    With ``check`` the values are held by ``check(outputs, dtype)`` on
    each package's results instead of against each other (structure,
    shapes and dtypes still compared)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    kwargs = dict(kwargs or {})
    port_kwargs = dict(port_kwargs or {})
    tol = dict(tol or {})
    for dtype in dtypes:
        r, a = tol.get(dtype, (rtol, atol))
        jargs = [to_jax(v, dtype, cast is None or i in cast)
                 for i, v in enumerate(np_inputs)]
        targs = [to_torch(v, dtype, cast is None or i in cast)
                 for i, v in enumerate(np_inputs)]
        jkw = {k: to_jax(v, dtype) for k, v in kwargs.items()}
        tkw = {k: to_torch(v, dtype) for k, v in kwargs.items()}
        want = leaves(_reference(ref_fn, jargs, jkw, dtype))
        with torch.no_grad():
            got = leaves(port_fn(*targs, **tkw, **port_kwargs))
        compare_leaves(got, want, r, a, what=f"{dtype} result",
                       values=check is None)
        if check is not None:
            check([g for g, _ in got], dtype)
            check([w for w, _ in want], dtype)
    if grad:
        _run_grads(ref_fn, port_fn, list(np_inputs), kwargs, port_kwargs,
                   None if cast is None else tuple(cast), rtol, atol)


def spec_parity(spec, ref_fn: Callable, port_fn: Callable, dtype: str,
                port_kwargs: Optional[Dict[str, Any]] = None) -> None:
    """``assert_parity`` of one validation spec in one dtype."""
    check = None
    if spec.check is not None:
        check = lambda outs, dt: spec.check(outs, spec, dt)  # noqa: E731
    r, a = spec.tolerance(dtype)
    assert_parity(ref_fn, port_fn, *spec.draw(), rtol=r, atol=a,
                  grad=spec.grad and dtype == "float32", dtypes=(dtype,),
                  kwargs=spec.kwargs, port_kwargs=port_kwargs,
                  cast=spec.cast, check=check)
