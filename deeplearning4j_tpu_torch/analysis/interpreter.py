"""Abstract interpreter of the shape/dtype evidence — walk a SameDiff node
list once, propagating symbolic shapes/dtypes (and a constant env) through
the per-op rules, collecting GC-coded findings with node provenance.

Counterpart of ``deeplearning4j_tpu/analysis/interpreter.py``
(``infer_nodes``, ``seed_avals``, ``check_samediff``). Resolution order
per node:

1. instance-local ops (control-flow closures) — deliberately opaque:
   outputs unknown, no finding;
2. a handwritten rule from ``rules.py`` (handles symbolic dims);
3. a probe of the real impl on ``torch.device("meta")`` tensors when
   every input is concrete — shapes and dtypes of the real impl at no
   cost, no data touched (the JAX package probes with ``jax.eval_shape``);
4. the sound unknown fallback + GC006.

Constant env: CONSTANT variables seed concrete values; a whitelisted set
of ops re-executes for real on CPU tensors (tiny arrays only) so
shape chains stay concrete through the walk, as they do at run time.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from deeplearning4j_tpu_torch.analysis.findings import Finding, make_finding
from deeplearning4j_tpu_torch.analysis.report import CheckReport
from deeplearning4j_tpu_torch.analysis.rules import RULES
from deeplearning4j_tpu_torch.analysis.values import AVal, CONST_VALUE_LIMIT

# ops re-executed on concrete inputs to keep the constant env flowing —
# the shape-chain surface plus the integer arithmetic that glues it
# together. Everything here is cheap on <=CONST_VALUE_LIMIT element arrays.
_CONST_EVAL_OPS = frozenset([
    "shape_of", "stack", "unstack", "unstack_first", "size", "cast",
    "concat", "squeeze", "expand_dims", "reshape", "transpose", "permute",
    "gather", "slice", "strided_slice", "identity",
    "add", "sub", "mul", "div", "floormod", "maximum", "minimum", "neg",
])

_PROBE_CACHE: Dict[Any, Optional[List[AVal]]] = {}
_PROBE_CACHE_MAX = 2048
_META = torch.device("meta")


def _resolve_impl(op: str, local_ops) -> Optional[Callable[..., Any]]:
    from deeplearning4j_tpu_torch.autodiff.samediff import resolve_graph_op

    try:
        return resolve_graph_op(op, local_ops)
    except KeyError:
        return None


def _canon_for_cache(kwargs: Dict[str, Any]):
    # the optimizer's hardened canonicalizer: tensors/arrays by bytes,
    # repr-sorted dict keys, None on anything un-canonicalizable
    from deeplearning4j_tpu_torch.autodiff.optimize import _canon_kwargs

    return _canon_kwargs(kwargs)


def _leaves(out) -> List[torch.Tensor]:
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _leaves(o)]
    raise TypeError(f"impl returned {type(out).__name__}, not tensors")


def _meta_probe(op: str, fn, ins: Sequence[AVal], kwargs: Dict[str, Any]
                ) -> Tuple[Optional[List[AVal]], Optional[str]]:
    """(avals, None) on success; (None, reason) otherwise."""
    if not ins or any(not a.is_concrete() or a.dtype is None for a in ins):
        return None, "inputs have symbolic/unknown shape or dtype"
    ck = _canon_for_cache(kwargs)
    cache_key = None
    if ck is not None:
        # the RESOLVED impl is part of the key: re-registering an op under
        # the same name must not serve the old impl's cached avals
        cache_key = (op, fn,
                     tuple((a.concrete_shape(), a.dtype) for a in ins), ck)
        cached = _PROBE_CACHE.get(cache_key)
        if cached is not None:
            return list(cached), None
    args = [torch.empty(a.concrete_shape(), dtype=a.dtype, device=_META)
            for a in ins]
    try:
        out = fn(*args, **kwargs)
        result = [AVal(tuple(int(d) for d in t.shape), t.dtype)
                  for t in _leaves(out)]
    except Exception as exc:  # noqa: BLE001 — the probe must never kill the walk
        return None, f"{type(exc).__name__}: {exc}"
    if cache_key is not None and len(_PROBE_CACHE) < _PROBE_CACHE_MAX:
        _PROBE_CACHE[cache_key] = result
    return result, None


def _const_eval(op: str, fn, node, ins: Sequence[AVal]
                ) -> Optional[List[AVal]]:
    """Execute the real impl on fully known small inputs (constant env),
    on CPU tensors: the values and dtypes are the ones the fold pass,
    which runs the same impls, produces."""
    if op not in _CONST_EVAL_OPS or fn is None:
        return None
    if op == "shape_of" and ins and ins[0].is_concrete():
        # the value depends only on the input SHAPE — concrete even when
        # the input tensor itself is not
        s = ins[0].concrete_shape()
        dt = torch.int64 if max(s, default=0) > 2**31 else torch.int32
        return [AVal.of_array(torch.tensor(s, dtype=dt), keep_value=True)]
    if op == "size" and ins and ins[0].is_concrete():
        return [AVal.of_array(torch.tensor(ins[0].num_elements(),
                                           dtype=torch.int32),
                              keep_value=True)]
    if any(a.value is None for a in ins):
        return None
    try:
        res = fn(*[a.value for a in ins], **node.kwargs)
    except Exception:  # noqa: BLE001 — the rule already reported what it could prove
        return None
    vals = [res] if len(node.outputs) == 1 else list(res)
    if len(vals) != len(node.outputs):
        return None
    out = []
    for v in vals:
        if not isinstance(v, torch.Tensor):
            return None
        out.append(AVal.of_array(v, keep_value=v.numel() <= CONST_VALUE_LIMIT))
    return out


def infer_nodes(indexed_nodes: Sequence[Tuple[int, Any]],
                avals: Dict[str, AVal],
                local_ops: Optional[Dict[str, Callable]] = None,
                graph_name: str = "<samediff>",
                findings: Optional[List[Finding]] = None,
                known_names: Optional[set] = None) -> Dict[str, AVal]:
    """Propagate avals through ``indexed_nodes`` [(node_index, node), ...]
    in order, mutating and returning ``avals``. ``known_names``: every
    name legally consumable before the walk (vars with values,
    placeholders, plan constants); defaults to ``avals``' keys. Findings
    (if a list is passed) collect GC-coded results."""
    local_ops = local_ops or {}
    sink: List[Finding] = findings if findings is not None else []
    defined = set(known_names if known_names is not None else avals)

    for idx, node in indexed_nodes:
        out_name = node.outputs[0] if node.outputs else "?"

        def emit(code: str, message: str, _idx=idx, _node=node,
                 _out=out_name):
            sink.append(make_finding(
                graph_name, _idx, code,
                f"node '{_out}' (op {_node.op}): {message}"))

        ins: List[AVal] = []
        dangling = False
        for name in node.inputs:
            if name not in defined:
                emit("GC004", f"consumes '{name}', which no variable or "
                              f"earlier node defines (dangling input / "
                              f"graph out of order)")
                dangling = True
                ins.append(AVal.unknown())
            else:
                ins.append(avals.get(name) or AVal.unknown())

        outs: Optional[List[AVal]] = None
        fn = _resolve_impl(node.op, local_ops)
        if node.op in local_ops:
            outs = [AVal.unknown() for _ in node.outputs]
        elif dangling:
            outs = [AVal.unknown() for _ in node.outputs]
        elif node.op in RULES:
            outs = RULES[node.op](node, ins, emit)
        elif fn is None:
            emit("GC006", "op is not resolvable in GRAPH_OPS or the "
                          "op registry; outputs are opaque")
        else:
            probed, reason = _meta_probe(node.op, fn, ins, node.kwargs)
            if probed is not None:
                outs = probed
            else:
                emit("GC006", f"no inference rule and the meta-tensor "
                              f"probe could not run ({reason}); outputs "
                              f"are opaque to the checker")

        # constant env: real execution on known small inputs wins
        concrete = _const_eval(node.op, fn, node, ins)
        if concrete is not None:
            outs = concrete

        if outs is None:
            outs = [AVal.unknown() for _ in node.outputs]
        if len(outs) < len(node.outputs):
            outs = list(outs) + [AVal.unknown()
                                 for _ in range(len(node.outputs) - len(outs))]
        for name, aval in zip(node.outputs, outs):
            avals[name] = aval
            defined.add(name)
    return avals


# ---------------------------------------------------------------------------
# SameDiff entry points
# ---------------------------------------------------------------------------


def seed_avals(sd) -> Tuple[Dict[str, AVal], set]:
    """(avals, known-names) for a SameDiff instance: bound arrays
    (VARIABLE/CONSTANT) give exact avals — constants keep their value for
    the constant env — and PLACEHOLDER declarations give symbolic avals
    (None/-1 axes become named Dims)."""
    avals: Dict[str, AVal] = {}
    known: set = set()
    for name, v in sd._vars.items():
        if name in sd._arrays:
            keep = v.vtype == "CONSTANT"
            avals[name] = AVal.of_array(sd._arrays[name], keep_value=keep)
            known.add(name)
        elif v.vtype == "PLACEHOLDER":
            avals[name] = AVal.of_placeholder(name, v.shape, v.dtype)
            known.add(name)
    return avals, known


def check_samediff(sd, outputs: Optional[Sequence[str]] = None,
                   graph_name: str = "<samediff>") -> CheckReport:
    """Verify a SameDiff graph statically. ``outputs=None`` checks every
    recorded node; with explicit outputs only their ancestor subgraph is
    walked (what a run of those outputs would execute)."""
    t0 = time.perf_counter()
    findings: List[Finding] = []
    avals, known = seed_avals(sd)

    indexed = list(enumerate(sd._nodes))
    if outputs is not None:
        wanted = set(outputs)
        keep: List[Tuple[int, Any]] = []
        for idx, node in reversed(indexed):
            if any(o in wanted for o in node.outputs):
                keep.append((idx, node))
                wanted.update(node.inputs)
        keep.reverse()
        indexed = keep

    infer_nodes(indexed, avals, sd._local_ops, graph_name, findings, known)

    # interface sanity: requested / recorded graph outputs must exist
    for out in (outputs if outputs is not None else sd.graph_outputs):
        if out not in sd._vars:
            findings.append(make_finding(
                graph_name, len(sd._nodes), "GC004",
                f"graph output '{out}' names no variable in the graph"))
    return CheckReport(graph_name, findings, avals,
                       seconds=time.perf_counter() - t0)
