"""Card-against-CPU consistency runner of the op catalog.

Counterpart of ``deeplearning4j_tpu/testing/consistency.py`` (its ``Case``
pattern, :23): every spec of the port's validation table
(:mod:`deeplearning4j_tpu_torch.ops.validation`) runs through the port's
registry on the card and on the CPU, in every dtype it takes, and the two
results must agree at the spec's tolerance. The registry call is the
descriptor's, so on the card an op with a hand-written kernel runs the
kernel wherever its gate admits the arguments, and the CPU runs its plain
version: the comparison holds the kernels too.

* structure, shapes and dtypes must be equal; floating values within the
  spec's (rtol, atol) for that dtype (``card_tol`` where the spec states
  a kernel's own bound), NaN where the CPU has NaN; integer and bool values
  equal;
* a spec with a ``check`` (random draws, factorizations free up to signs)
  is held by that check on each device's result, and a random draw must
  also repeat bit for bit on the card from the same seed;
* float32 products run in float32 (no TF32), as the CPU computes them.

A crash is a recorded failure, not an abort; :func:`run_catalog` returns
the counts and every failure, and chip_smoke's ``op_catalog`` phase fails
on any.

Run on a host with a card: ``python -m deeplearning4j_tpu_torch.testing.consistency``.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.ops import registry
from deeplearning4j_tpu_torch.ops import validation as V

_TORCH = {"bfloat16": torch.bfloat16, "float16": torch.float16,
          "float32": torch.float32}


def to_device(v, dtype: str, castable: bool, device) -> Any:
    """A spec input on ``device``, under the validation conventions."""
    if isinstance(v, list):
        return [to_device(x, dtype, castable, device) for x in v]
    if isinstance(v, V.Key):
        return torch.Generator(device=device).manual_seed(v.seed)
    if isinstance(v, np.ndarray):
        if v.dtype.kind == "f":
            t = torch.from_numpy(np.ascontiguousarray(v.astype(np.float32)))
            return (t.to(_TORCH[dtype]) if castable else t).to(device)
        if v.dtype == np.int64:
            v = v.astype(np.int32)
        return torch.from_numpy(np.ascontiguousarray(v)).to(device)
    return v


def leaf(x) -> Tuple[np.ndarray, str]:
    """(values as a numpy array, dtype name) of one result leaf."""
    if isinstance(x, torch.Tensor):
        name = str(x.dtype).replace("torch.", "")
        t = x.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy(), name
    a = np.asarray(x)
    return a, a.dtype.name


def run_spec(spec: V.Case, dtype: str, device) -> List[Tuple[np.ndarray, str]]:
    """The spec's result leaves on ``device`` (numpy values, dtype names)."""
    from deeplearning4j_tpu_torch.nn import dtype as DT

    desc = registry().get(spec.op)
    args = [to_device(v, dtype, spec.casts(i), device)
            for i, v in enumerate(spec.draw())]
    kwargs = {k: to_device(v, dtype, True, device)
              for k, v in spec.kwargs.items()}
    if V.takes_device(desc.fn) and "device" not in kwargs:
        kwargs["device"] = str(device)
    with torch.no_grad(), DT.precision_scope("float32"):
        out = desc(*args, **kwargs)
    return [leaf(x) for x in V.flatten(out)]


def _float_name(name: str) -> bool:
    return name in ("float16", "bfloat16", "float32", "float64")


def compare(got, want, rtol: float, atol: float,
            values: bool = True) -> Optional[str]:
    """The first difference between two leaf lists (structure, shapes,
    dtypes and, with ``values``, the values), or None."""
    if len(got) != len(want):
        return f"{len(got)} leaves on the card, {len(want)} on the CPU"
    for i, ((g, gd), (w, wd)) in enumerate(zip(got, want)):
        if gd != wd:
            return f"leaf {i}: dtype {gd} on the card, {wd} on the CPU"
        if g.shape != w.shape:
            return f"leaf {i}: shape {g.shape} on the card, {w.shape} on the CPU"
        if not values:
            continue
        if _float_name(wd):
            g64, w64 = g.astype(np.float64), w.astype(np.float64)
            bad = ~(np.isclose(g64, w64, rtol=rtol, atol=atol,
                               equal_nan=True))
            if bad.any():
                err = np.abs(g64 - w64)[bad]
                return (f"leaf {i}: {int(bad.sum())} of {g.size} outside "
                        f"rtol {rtol:g} atol {atol:g}, max |diff| "
                        f"{float(np.nanmax(err)):.3g}")
        elif not np.array_equal(g, w):
            return f"leaf {i}: {int((g != w).sum())} of {g.size} differ"
    return None


def check_spec(spec: V.Case, dtype: str, device) -> Optional[str]:
    """None when the spec agrees on ``device`` and the CPU, else why not."""
    try:
        got = run_spec(spec, dtype, device)
        want = run_spec(spec, dtype, torch.device("cpu"))
        if spec.check is not None:
            for where, leaves in (("card", got), ("cpu", want)):
                try:
                    spec.check([v for v, _ in leaves], spec, dtype)
                except AssertionError as e:
                    return f"{where} check: {str(e)[:200]}"
            why = compare(got, want, 0.0, 0.0, values=False)
            if why is None and any(isinstance(v, V.Key) for v in spec.draw()):
                again = run_spec(spec, dtype, device)
                why = compare(again, got, 0.0, 0.0)
                if why is not None:
                    why = "the same seed drew differently: " + why
            return why
        rtol, atol = spec.card_tolerance(dtype)
        return compare(got, want, rtol, atol)
    except Exception as e:  # a crash is a recorded failure, not an abort
        return f"crash: {type(e).__name__}: {str(e)[:200]}"


def run_catalog(device, ops: Optional[Sequence[str]] = None
                ) -> Dict[str, Any]:
    """Every spec of the table (or of ``ops``) in every dtype it takes, on
    ``device`` against the CPU. Returns the counts of ops, cases and
    failures, the failures themselves and the wall seconds."""
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    table = V.cases()
    names = sorted(table) if ops is None else list(ops)
    failures: List[str] = []
    n_cases = 0
    for name in names:
        for spec in table[name]:
            for dtype in spec.dtypes:
                n_cases += 1
                why = check_spec(spec, dtype, device)
                if why is not None:
                    failures.append(f"{spec.name} {dtype}: {why}")
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return {"ops": len(names), "cases": n_cases,
            "failures": len(failures), "failed": failures,
            "uncovered": V.uncovered_ops(),
            "seconds": time.perf_counter() - t0}


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device: the runner compares a card with the CPU",
              file=sys.stderr)
        return 1
    out = run_catalog(torch.device("cuda"))
    print(json.dumps(out))
    return 0 if out["failures"] == 0 and not out["uncovered"] else 1


if __name__ == "__main__":
    sys.exit(main())
