"""SameDiff graph optimizer of the port — the pre-run pass pipeline.

Counterpart of ``deeplearning4j_tpu/autodiff/optimize.py``. The importers
emit every source node verbatim, so imported graphs carry dead branches,
per-layer duplicated subexpressions (attention-mask expansion chains),
foldable constant chains and no-op Identity/Dropout/Reshape nodes. The
pipeline shrinks the node list before it runs, and its fusion tier
rewrites imported subgraphs onto the registry ops that carry the
hand-written CUDA kernels.

Passes (each independently sound; the pipeline loops to a fixpoint):

``dce``        dead-code elimination backwards from the requested outputs.
``fold``       constant folding: a node whose inputs are all CONSTANT-derived
               (never VARIABLE) is evaluated once and its outputs become
               plan-local constants. Plans are cached in
               ``SameDiff._jit_cache``, which ``set_arr`` on a CONSTANT and
               every graph mutation clear.
``cse``        common-subexpression elimination keyed on
               (op, input ids, canonical kwargs).
``algebraic``  identity cleanup: identity nodes, transpose∘transpose,
               reshape∘reshape, reshape-to-same-shape, and x*1 / x+0 / x-0 /
               x/1 / x**1 strips (only when the surviving operand's dtype
               provably absorbs the promotion).
``fusion``     matmul→scale→(+mask)→softmax→matmul becomes ONE
               ``dot_product_attention`` node (the flash kernel on the
               card), matmul+bias(+activation) becomes
               ``fused_matmul_bias_act`` (the fused matmul kernel), and a
               trailing-axis layer norm feeding a GELU becomes
               ``fused_layer_norm``. Opt-out: ``passes=`` without it.

The JAX package's environment switches (``DL4J_TPU_FUSION``,
``DL4J_TPU_CHECK_PASSES``, ``DL4J_TPU_AUTOCAST``) are not read: the
pipeline is chosen by ``passes=`` (``SameDiff(optimize_passes=...)``) and
the checker by ``check_invariants=``. The opt-in ``autocast`` pass is not
ported yet; asking for it raises.

The matchers and the pass-invariance checker read the shape/dtype evidence
of the port's ``analysis`` package, with the JAX package's dtype
promotion, so they decide exactly as the JAX matchers do; a test holds
the plans of the two packages equal op for op.

The result is a :class:`GraphPlan` — an optimized node list, extra folded
constants, and an alias map — which ``SameDiff._interpret`` executes
instead of the raw recording. The graph itself (``sd._nodes``) is never
mutated.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.analysis.broadcast import (
    is_float_dtype, promote_types)

PASS_ORDER: Tuple[str, ...] = ("dce", "fold", "cse", "algebraic", "fusion")

# the JAX package's opt-in passes (valid `passes=` names outside the
# default pipeline): none is ported yet, and asking for one raises
_NOT_PORTED_PASSES = ("autocast",)
_AUTOCAST_NOT_PORTED = (
    "the optimizer's opt-in 'autocast' pass is not ported yet (ROADMAP.md, "
    "Queue 1 item 6)")


# folded outputs larger than this (elements) stay in the graph:
# materializing giants at plan time costs memory with no wall-clock win
FOLD_SIZE_LIMIT = 1 << 24

_MAX_ITERS = 10  # fixpoint safety cap; real graphs settle in 2-3


@dataclasses.dataclass
class OptimizeStats:
    """Per-compile instrumentation (SameDiff.last_compile_stats)."""

    nodes_before: int = 0
    nodes_after: int = 0
    # pass name -> {"before": n at first application, "after": n at last,
    #               "removed": cumulative node delta across iterations}
    passes: Dict[str, Dict[str, int]] = dataclasses.field(default_factory=dict)
    optimize_seconds: float = 0.0
    # populated by CompiledGraph on the output() path: the warm-up run and
    # the CUDA-graph capture of its first call (the reference's trace and
    # XLA compile); None where nothing was captured
    trace_seconds: Optional[float] = None
    compile_seconds: Optional[float] = None
    # pass-invariance runs of the abstract interpreter: how many times
    # the interface shapes/dtypes were re-verified between passes
    invariant_checks: int = 0
    # fusion-tier hit counts: {"attention": n, "epilogue": n,
    # "autocast_casts": n} — docs/OPTIMIZER.md § Fusion tier
    fusions: Dict[str, int] = dataclasses.field(default_factory=dict)

    def record_fusion(self, kind: str, n: int = 1) -> None:
        self.fusions[kind] = self.fusions.get(kind, 0) + n

    def record_pass(self, name: str, before: int, after: int) -> None:
        entry = self.passes.setdefault(
            name, {"before": before, "after": after, "removed": 0})
        entry["after"] = after
        entry["removed"] += before - after

    @property
    def removed(self) -> int:
        return self.nodes_before - self.nodes_after

    def to_dict(self) -> Dict[str, Any]:
        return {"nodes_before": self.nodes_before,
                "nodes_after": self.nodes_after,
                "removed": self.removed,
                "passes": {k: dict(v) for k, v in self.passes.items()},
                "optimize_seconds": round(self.optimize_seconds, 4),
                "trace_seconds": self.trace_seconds,
                "compile_seconds": self.compile_seconds,
                "invariant_checks": self.invariant_checks,
                "fusions": dict(self.fusions)}


class GraphPlan:
    """Optimized execution plan for one requested-output set."""

    __slots__ = ("nodes", "extra_consts", "alias", "outputs", "stats")

    def __init__(self, nodes, extra_consts, alias, outputs, stats):
        self.nodes = nodes
        self.extra_consts = extra_consts  # folded values, merged into env
        self.alias = alias                # removed-output name -> survivor
        self.outputs = outputs
        self.stats = stats

    def resolve(self, name: str) -> str:
        return _resolve(self.alias, name)


def _tensor_bytes(t: torch.Tensor) -> bytes:
    return t.detach().reshape(-1).contiguous().cpu().view(
        torch.uint8).numpy().tobytes()


def _resolve(alias: Dict[str, str], name: str) -> str:
    seen = []
    while name in alias:
        seen.append(name)
        name = alias[name]
    for s in seen:  # path compression keeps chains O(1) amortized
        alias[s] = name
    return name


def _copy_node(n):
    return type(n)(n.op, list(n.inputs), dict(n.kwargs), list(n.outputs))


def _rewrite_inputs(nodes, alias: Dict[str, str]) -> bool:
    changed = False
    for n in nodes:
        for i, name in enumerate(n.inputs):
            r = _resolve(alias, name)
            if r != name:
                n.inputs[i] = r
                changed = True
    return changed


# ---------------------------------------------------------------------------
# dce
# ---------------------------------------------------------------------------


def _dce(nodes, outputs: Sequence[str], alias: Dict[str, str]):
    needed = {_resolve(alias, o) for o in outputs}
    keep = []
    for n in reversed(nodes):
        if any(o in needed for o in n.outputs):
            keep.append(n)
            needed.update(n.inputs)
    keep.reverse()
    return keep, len(keep) != len(nodes)


# ---------------------------------------------------------------------------
# fold
# ---------------------------------------------------------------------------


def _fold(nodes, const_vals: Dict[str, Any], resolve_op, local_ops,
          size_limit: int, precision_policy: str):
    from deeplearning4j_tpu_torch.nn import dtype as DT

    out_nodes, changed = [], False
    with DT.precision_scope(precision_policy):
        for n in nodes:
            if n.op in local_ops or any(i not in const_vals for i in n.inputs):
                out_nodes.append(n)
                continue
            try:
                fn = resolve_op(n.op)
                res = fn(*[const_vals[i] for i in n.inputs], **n.kwargs)
            except Exception:  # noqa: BLE001 — any failure means "leave it"
                # not statically evaluable (shape mismatch under fold,
                # helper needing a device feature, ...) — leave it in place
                out_nodes.append(n)
                continue
            vals = [res] if len(n.outputs) == 1 else list(res)
            if (len(vals) != len(n.outputs)
                    or any(not isinstance(v, torch.Tensor)
                           or v.numel() > size_limit for v in vals)):
                out_nodes.append(n)
                continue
            for name, val in zip(n.outputs, vals):
                const_vals[name] = val
            changed = True
    return out_nodes, changed


# ---------------------------------------------------------------------------
# cse
# ---------------------------------------------------------------------------


def _canon_kwargs(kwargs: Dict[str, Any]):
    def c(v):
        if isinstance(v, (list, tuple)):
            return tuple(c(x) for x in v)
        if isinstance(v, dict):
            # repr-sort the keys: mixed-type keys (int vs str) are
            # unorderable and would abort the whole pass pipeline
            return tuple(sorted(((k, c(x)) for k, x in v.items()),
                                key=lambda kv: repr(kv[0])))
        if isinstance(v, np.ndarray):
            return ("__nd", v.shape, str(v.dtype), v.tobytes())
        if isinstance(v, torch.Tensor):
            return ("__t", tuple(v.shape), str(v.dtype), _tensor_bytes(v))
        if isinstance(v, torch.dtype):
            return ("__dt", str(v))
        return v

    # Exclude-from-CSE fallback must cover EVERYTHING canonicalization can
    # throw, not just TypeError: ndarray-like values with ambiguous
    # truthiness raise ValueError inside sorted(), device arrays can raise
    # their own errors from repr/compare, self-referential containers hit
    # RecursionError. Any failure means "this node is not CSE-able",
    # never "the optimizer pipeline dies".
    try:
        key = tuple(sorted((k, c(v)) for k, v in kwargs.items()))
        hash(key)
    except Exception:
        return None  # not canonicalizable/hashable — not CSE-able
    return key


def _cse(nodes, alias: Dict[str, str], local_ops):
    seen: Dict[Any, Any] = {}
    out_nodes, changed = [], False
    for n in nodes:
        if n.op in local_ops:  # opaque control-flow closures: never merge
            out_nodes.append(n)
            continue
        ck = _canon_kwargs(n.kwargs)
        if ck is None:
            out_nodes.append(n)
            continue
        key = (n.op, tuple(n.inputs), ck)
        prev = seen.get(key)
        if prev is None:
            seen[key] = n
            out_nodes.append(n)
        else:
            for o, po in zip(n.outputs, prev.outputs):
                alias[o] = po
            changed = True
    return out_nodes, changed


# ---------------------------------------------------------------------------
# algebraic
# ---------------------------------------------------------------------------

# unary ops whose output dtype equals a floating input's dtype
_DTYPE_PRESERVING_UNARY = frozenset([
    "identity", "neg", "abs", "exp", "log", "log1p", "sqrt", "rsqrt",
    "square", "sign", "floor", "ceil", "round", "sin", "cos", "tan",
    "tanh", "sinh", "cosh", "erf", "relu", "relu6", "elu", "selu", "gelu",
    "sigmoid", "softplus", "softsign", "swish", "mish", "leakyrelu",
    "softmax", "log_softmax", "reshape", "transpose", "permute",
    "expand_dims", "squeeze", "tile", "reduce_sum", "reduce_mean",
    "reduce_max", "reduce_min", "zeros_like", "ones_like",
])
_DTYPE_PROMOTING_BINARY = frozenset(
    ["add", "sub", "mul", "div", "pow", "maximum", "minimum", "mmul"])


def _np_inexact(dt) -> bool:
    """``np.issubdtype(dt, np.inexact)`` as the JAX package evaluates it on
    numpy dtypes: bfloat16 and float8 are numpy extension types (kind
    'V'), not inexact."""
    return (dt is not None and is_float_dtype(dt) and dt.itemsize > 1
            and dt != torch.bfloat16)


def _infer_dtypes(nodes, const_vals, seed_dtypes):
    """Best-effort forward dtype propagation (floating dtypes only). A name
    absent from the result means "unknown" — identity strips then bail."""
    from deeplearning4j_tpu_torch.analysis.values import as_dtype

    dt: Dict[str, Any] = dict(seed_dtypes)
    for name, v in const_vals.items():
        vd = getattr(v, "dtype", None)
        if vd is not None:
            dt[name] = as_dtype(vd)
    for n in nodes:
        ins = [dt.get(i) for i in n.inputs]
        if n.op == "cast":
            try:
                dt[n.outputs[0]] = as_dtype(n.kwargs.get("dtype"))
            except TypeError:
                pass
        elif (n.op in _DTYPE_PRESERVING_UNARY and ins and ins[0] is not None
                and _np_inexact(ins[0])):
            dt[n.outputs[0]] = ins[0]
        elif (n.op in _DTYPE_PROMOTING_BINARY and len(ins) >= 2
                and all(_np_inexact(d) for d in ins[:2])):
            dt[n.outputs[0]] = promote_types(ins[0], ins[1])
    return dt


def _scalar_const(const_vals, name):
    """0-d (or absent) → (value, dtype) for identity matching; None if the
    constant is non-scalar (a broadcast would change the result shape)."""
    v = const_vals.get(name)
    if v is None:
        return None
    if v.ndim != 0:
        return None
    try:
        return float(v), v.dtype
    except (TypeError, ValueError, RuntimeError):
        return None


# op -> (identity value, which operand positions may carry it)
_BINARY_IDENTITIES = {"mul": (1.0, (0, 1)), "add": (0.0, (0, 1)),
                      "sub": (0.0, (1,)), "div": (1.0, (1,)),
                      "pow": (1.0, (1,))}


def _algebraic(nodes, const_vals, var_shapes, seed_dtypes,
               alias: Dict[str, str], local_ops):
    dtypes = _infer_dtypes(nodes, const_vals, seed_dtypes)
    producer = {o: n for n in nodes for o in n.outputs}
    out_nodes, changed = [], False

    def known_shape(name):
        s = var_shapes.get(name)
        if s is not None:
            return s
        v = const_vals.get(name)
        return tuple(v.shape) if v is not None else None

    def perm_of(axes, rank):
        return (tuple(reversed(range(rank))) if axes is None
                else tuple(int(a) for a in axes))

    for n in nodes:
        if n.op in local_ops:
            out_nodes.append(n)
            continue

        if n.op == "identity" and len(n.outputs) == 1:
            alias[n.outputs[0]] = n.inputs[0]
            changed = True
            continue

        if n.op == "transpose" and len(n.inputs) == 1:
            inner = producer.get(n.inputs[0])
            if inner is not None and inner.op == "transpose":
                a_out = n.kwargs.get("axes")
                a_in = inner.kwargs.get("axes")
                rank = (len(a_out) if a_out is not None
                        else len(a_in) if a_in is not None else None)
                if a_out is None and a_in is None:
                    # reverse twice = identity at any rank
                    alias[n.outputs[0]] = inner.inputs[0]
                    changed = True
                    continue
                if rank is not None:
                    p_in = perm_of(a_in, rank)
                    p_out = perm_of(a_out, rank)
                    combined = tuple(p_in[k] for k in p_out)
                    if combined == tuple(range(rank)):
                        alias[n.outputs[0]] = inner.inputs[0]
                        changed = True
                        continue
                    if n.inputs[0] != inner.inputs[0] or \
                            n.kwargs.get("axes") != combined:
                        n.inputs[0] = inner.inputs[0]
                        n.kwargs["axes"] = combined
                        changed = True
            out_nodes.append(n)
            continue

        if n.op == "reshape" and len(n.inputs) == 1:
            target = n.kwargs.get("shape")
            inner = producer.get(n.inputs[0])
            if inner is not None and inner.op == "reshape":
                # reshape∘reshape ≡ the outer reshape (row-major order)
                n.inputs[0] = inner.inputs[0]
                changed = True
            src = known_shape(n.inputs[0])
            if (target is not None and src is not None
                    and all(int(d) >= 0 for d in target)
                    and tuple(int(d) for d in target) == tuple(src)):
                alias[n.outputs[0]] = n.inputs[0]
                changed = True
                continue
            out_nodes.append(n)
            continue

        ident = _BINARY_IDENTITIES.get(n.op)
        if ident is not None and len(n.inputs) == 2:
            value, positions = ident
            stripped = False
            for pos in positions:
                sc = _scalar_const(const_vals, n.inputs[pos])
                if sc is None or sc[0] != value:
                    continue
                other = n.inputs[1 - pos]
                dt_other = dtypes.get(other)
                # only strip when the surviving operand's dtype provably
                # absorbs the promotion — else x(bf16)+0.0(f32) would
                # silently change the result dtype/precision
                if not _np_inexact(dt_other):
                    continue
                if promote_types(dt_other, sc[1]) != dt_other:
                    continue
                alias[n.outputs[0]] = other
                changed = True
                stripped = True
                break
            if stripped:
                continue

        out_nodes.append(n)
    return out_nodes, changed


# ---------------------------------------------------------------------------
# fusion (docs/OPTIMIZER.md § Fusion tier)
#
# Pattern-match imported subgraphs onto registry fast paths:
#   * attention: matmul → scale → (+additive mask) → softmax → matmul
#     becomes ONE `dot_product_attention` node, so the flash kernel
#     (ops/cuda_attention.py) applies to imported graphs.
#   * epilogue: matmul + bias (+ relu/tanh/gelu or the decomposed erf-gelu
#     chain exporters emit) becomes `fused_matmul_bias_act` (the fused
#     matmul kernel, ops/cuda_matmul.py, on the card; the same op chain
#     elsewhere).
#
# Soundness: a rewrite only fires when the shape/dtype evidence (from the
# abstract interpreter over bound arrays, placeholder decls and the const
# env) proves the pattern — scale value matches 1/sqrt(head_dim),
# softmax normalizes the last axis, the mask chain is the standard
# (1 - mask) * -big penalty, and every interior tensor is consumed only
# inside the pattern. Anything else is left verbatim; the per-pass
# invariant checker then re-verifies the fused graph via the first-class
# analysis rules for the fused ops.
# ---------------------------------------------------------------------------

_FUSION_PASSTHROUGH = frozenset(["identity", "dropout_graph"])

# epilogue activations matched as a single node (op name -> activation kwarg)
_EPILOGUE_ACTS = {"relu": "relu", "tanh": "tanh", "gelu": "gelu"}

_SQRT2 = float(np.sqrt(np.float32(2.0)))


class _Namer:
    """Fresh names for synthesized nodes, collision-checked per pipeline."""

    def __init__(self, taken):
        self._taken = taken
        self._n = 0

    def fresh(self, tag: str) -> str:
        while True:
            self._n += 1
            name = f"__opt_{tag}_{self._n}"
            if name not in self._taken:
                self._taken.add(name)
                return name


def _abstract_avals(nodes, const_vals, var_shapes, seed_dtypes, input_avals,
                    local_ops):
    """Shape/dtype evidence for the fusion matchers — the same seeding the
    invariant checker uses, walked once over the current list."""
    from deeplearning4j_tpu_torch import analysis as _an

    avals: Dict[str, Any] = {}
    for n, s in (var_shapes or {}).items():
        avals[n] = _an.AVal(shape=tuple(s), dtype=(seed_dtypes or {}).get(n))
    for n, dt in (seed_dtypes or {}).items():
        if n not in avals:
            avals[n] = _an.AVal(dtype=dt)
    for n, a in (input_avals or {}).items():
        avals.setdefault(n, a)
    for n, v in const_vals.items():
        avals[n] = _an.AVal.of_array(v, keep_value=v.numel() <= 4096)
    _an.infer_nodes(list(enumerate(nodes)), avals, local_ops,
                    graph_name="<fusion>", findings=[])
    return avals


def _close(a: float, b: float, rtol: float = 1e-5) -> bool:
    return abs(a - b) <= rtol * max(abs(a), abs(b), 1e-30)


def _identity_perm(perm) -> bool:
    return tuple(perm) == tuple(range(len(perm)))


def _norm_perm(axes, rank):
    if axes is None:
        return tuple(reversed(range(rank)))
    return tuple(int(a) % rank for a in axes)


class _GraphView:
    """Shared lookup state for one fusion-pass application."""

    def __init__(self, nodes, outputs, alias, const_vals, avals,
                 local_ops=None):
        self.nodes = nodes
        self.const_vals = const_vals
        self.avals = avals
        self.local_ops = local_ops or {}
        self.producer: Dict[str, Tuple[int, Any]] = {}
        self.consumers: Dict[str, int] = {}
        # name -> [(idx, node), ...] distinct consumer NODES, in order
        self._consumer_nodes: Dict[str, List[Tuple[int, Any]]] = {}
        for idx, n in enumerate(nodes):
            for o in n.outputs:
                self.producer[o] = (idx, n)
            for i in n.inputs:
                self.consumers[i] = self.consumers.get(i, 0) + 1
                lst = self._consumer_nodes.setdefault(i, [])
                if not lst or lst[-1][0] != idx:
                    lst.append((idx, n))
        self.external = {_resolve(alias, o) for o in outputs}

    def interior(self, name: str) -> bool:
        """name is consumed exactly once and is not a requested output —
        the precondition for removing its producer."""
        return self.consumers.get(name, 0) == 1 and name not in self.external

    def single_consumer(self, name: str):
        """(idx, node) of the unique consumer of name, or None."""
        if not self.interior(name):
            return None
        lst = self._consumer_nodes.get(name)
        return lst[0] if lst else None

    def consumer_nodes(self, name: str):
        """All distinct consumer (idx, node) pairs of name, in order."""
        return self._consumer_nodes.get(name, [])

    def is_op(self, node, *names) -> bool:
        """node matches one of the CATALOG ops ``names`` — an
        instance-local op shadowing a catalog name (resolution order is
        local-first) has arbitrary semantics and must never pattern-match."""
        return node.op in names and node.op not in self.local_ops

    def scalar(self, name: str):
        """(value, dtype) for any SIZE-1 constant — unlike the algebraic
        strips' 0-d-only ``_scalar_const``, rank does not matter here: the
        fusion rewrite removes the whole chain, so a (1,)-shaped ONNX
        scalar (the wire format's usual encoding) is as good as a 0-d."""
        v = self.const_vals.get(name)
        if v is None:
            return None
        if v.numel() != 1:
            return None
        try:
            return float(v.reshape(())), v.dtype
        except (TypeError, ValueError, RuntimeError):
            return None

    def aval(self, name: str):
        return self.avals.get(name)


def _match_mask_penalty(gv: _GraphView, name: str):
    """Recognize the additive attention-mask penalty chains importers emit.

    Returns ``("tensor", mask_name, expand_axes)`` for the standard
    ``(1 - mask) * -big`` key-padding chain (``expand_axes``: expand_dims
    axes applied AFTER the mul, to mirror onto the mask),
    ``("causal", None, None)`` for a constant lower-triangular 0/-big
    matrix, or None."""
    # constant additive mask: causal tril pattern (decoder imports)
    v = gv.const_vals.get(name)
    if v is not None:
        sq = v.reshape(v.shape[-2:]) if v.ndim > 2 and \
            all(d == 1 for d in v.shape[:-2]) else v
        if sq.ndim == 2 and sq.shape[0] == sq.shape[1] and sq.shape[0] > 1:
            tril = torch.ones(tuple(sq.shape), dtype=torch.bool,
                              device=sq.device).tril()
            if bool(torch.all(sq[tril] == 0.0)) and \
                    bool(torch.all(sq[~tril] <= -1e3)):
                return ("causal", None, None)
        return None
    expand_axes = []
    prod = gv.producer.get(name)
    while prod is not None and gv.is_op(prod[1], "expand_dims"):
        expand_axes.append(prod[1].kwargs.get("axis", 0))
        name = prod[1].inputs[0]
        prod = gv.producer.get(name)
    if prod is None or not gv.is_op(prod[1], "mul") \
            or len(prod[1].inputs) != 2:
        return None
    mul = prod[1]
    for pos in (0, 1):
        sc = gv.scalar(mul.inputs[pos])
        if sc is None or sc[0] > -1e3:
            continue
        inv = gv.producer.get(mul.inputs[1 - pos])
        if inv is None or not gv.is_op(inv[1], "sub") \
                or len(inv[1].inputs) != 2:
            continue
        one = gv.scalar(inv[1].inputs[0])
        if one is None or one[0] != 1.0:
            continue
        mask_name = inv[1].inputs[1]
        a = gv.aval(mask_name)
        # mask contract: a float/bool BINARY attend mask. The matched
        # (1 - mask) * -big chain is the exporters' encoding of a 0/1
        # key-padding mask; the rewrite turns it into the fused op's
        # where-style mask operand, which agrees with the additive penalty
        # exactly for 0/1 values (ONNX Runtime's attention fuser makes the
        # same binary-mask assumption). Fractional masks are outside the
        # pattern: provably-non-binary CONSTANT masks are rejected here,
        # runtime-fed masks are 0/1 by the documented contract
        # (docs/OPTIMIZER.md § Fusion tier; opt-out: passes= without fusion).
        # Unknown or integral dtypes are a pattern miss — leave verbatim.
        if a is None or a.dtype is None:
            return None
        # np.floating as the JAX package reads it: float16/32/64 — not
        # bfloat16 or float8 (numpy extension types)
        if not ((_np_inexact(a.dtype) and not a.dtype.is_complex)
                or a.dtype == torch.bool):
            return None
        mv = gv.const_vals.get(mask_name)
        if mv is not None:
            if not bool(torch.all((mv == 0) | (mv == 1))):
                return None
        return ("tensor", mask_name, list(reversed(expand_axes)))
    return None


def _peel_transposed_k(gv: _GraphView, kt_name: str, namer: _Namer):
    """scores = q @ B requires B = kᵀ (last two axes swapped). Recover k:
    if B is a transpose node, compose its perm with a last-two swap — the
    result is either the transpose's own input (plain kᵀ) or one
    synthesized transpose (the composed head-split form the algebraic pass
    produces). Returns (k_name, synth_node_or_None, kt_idx_or_None,
    k_shape) or None."""
    prod = gv.producer.get(kt_name)
    if prod is None or not gv.is_op(prod[1], "transpose") \
            or len(prod[1].inputs) != 1:
        return None
    kt_idx, kt = prod
    axes = kt.kwargs.get("axes")
    src_aval = gv.aval(kt.inputs[0])
    rank = len(axes) if axes is not None else \
        (src_aval.rank if src_aval is not None else None)
    if rank is None or rank < 2:
        return None
    perm = _norm_perm(axes, rank)
    k_perm = perm[:-2] + (perm[-1], perm[-2])
    src_shape = src_aval.shape if src_aval is not None else None
    k_shape = (tuple(src_shape[p] for p in k_perm)
               if src_shape is not None and len(src_shape) == rank else None)
    if _identity_perm(k_perm):
        return kt.inputs[0], None, kt_idx, k_shape
    synth = _Node_like(kt, "transpose", [kt.inputs[0]], {"axes": k_perm},
                       [namer.fresh("k")])
    return synth.outputs[0], synth, kt_idx, k_shape


def _Node_like(template, op, inputs, kwargs, outputs):
    return type(template)(op, list(inputs), dict(kwargs), list(outputs))


def _try_attention(gv: _GraphView, ctx_idx: int, ctx, namer: _Namer):
    """Match one attention block ending at ``ctx = mmul(probs, v)``.

    Returns ``(removed_idxs, synth_nodes, fused_node, mask_pending)`` or
    None. ``mask_pending`` is None or ``(mask_name, expand_axes)``: a
    tensor mask the CALLER appends to the fused node's inputs — after the
    claim check accepts the match — synthesizing (and caching) any
    expand_dims mirror chain only for matches that actually apply."""
    if not gv.is_op(ctx, "mmul") or len(ctx.inputs) != 2 or \
            ctx.kwargs.get("transpose_a") or ctx.kwargs.get("transpose_b"):
        return None
    removed = {ctx_idx}
    synth: List[Any] = []

    # probs side: optional identity/dropout passthroughs over the softmax
    p_name, v_name = ctx.inputs
    while True:
        prod = gv.producer.get(p_name)
        if prod is None:
            return None
        if gv.is_op(prod[1], *_FUSION_PASSTHROUGH) \
                and len(prod[1].outputs) == 1:
            if not gv.interior(prod[1].outputs[0]):
                return None
            removed.add(prod[0])
            p_name = prod[1].inputs[0]
            continue
        break
    sm_idx, sm = prod
    if not gv.is_op(sm, "softmax") or not gv.interior(sm.outputs[0]):
        return None
    axis = int(sm.kwargs.get("axis", -1))
    sm_aval = gv.aval(sm.inputs[0])
    rank = sm_aval.rank if sm_aval is not None else None
    if axis != -1 and (rank is None or axis != rank - 1):
        return None
    removed.add(sm_idx)

    # optional additive mask
    s_name = sm.inputs[0]
    prod = gv.producer.get(s_name)
    if prod is None:
        return None
    mask = None
    if gv.is_op(prod[1], "add") and len(prod[1].inputs) == 2:
        if not gv.interior(prod[1].outputs[0]):
            return None
        for pos in (0, 1):
            mask = _match_mask_penalty(gv, prod[1].inputs[pos])
            if mask is not None:
                removed.add(prod[0])
                s_name = prod[1].inputs[1 - pos]
                prod = gv.producer.get(s_name)
                break
        if mask is None:
            return None  # an add that is not a recognized mask penalty
        if prod is None:
            return None

    # optional scale on the scores: (kind, value, const name). The NAME is
    # kept because the rewrite re-applies the ORIGINAL constant to q (see
    # below) — never a freshly computed sqrt.
    scale = None
    if gv.is_op(prod[1], "div") and len(prod[1].inputs) == 2:
        sc = gv.scalar(prod[1].inputs[1])
        if sc is not None:
            if not gv.interior(prod[1].outputs[0]):
                return None
            scale = ("div", sc[0], prod[1].inputs[1])
            removed.add(prod[0])
            s_name = prod[1].inputs[0]
            prod = gv.producer.get(s_name)
    elif gv.is_op(prod[1], "mul") and len(prod[1].inputs) == 2:
        for pos in (0, 1):
            sc = gv.scalar(prod[1].inputs[pos])
            if sc is not None:
                if not gv.interior(prod[1].outputs[0]):
                    return None
                scale = ("mul", sc[0], prod[1].inputs[pos])
                removed.add(prod[0])
                s_name = prod[1].inputs[1 - pos]
                prod = gv.producer.get(s_name)
                break
    if prod is None:
        return None

    scores_idx, scores = prod
    if not gv.is_op(scores, "mmul") or len(scores.inputs) != 2 or \
            scores.kwargs.get("transpose_a") or \
            not gv.interior(scores.outputs[0]):
        return None
    removed.add(scores_idx)

    q_name = scores.inputs[0]
    if scores.kwargs.get("transpose_b"):
        k_name, k_shape = scores.inputs[1], None
        ka = gv.aval(k_name)
        if ka is not None:
            k_shape = ka.shape
    else:
        peeled = _peel_transposed_k(gv, scores.inputs[1], namer)
        if peeled is None:
            return None
        k_name, k_synth, kt_idx, k_shape = peeled
        if k_synth is not None:
            synth.append(k_synth)
        if gv.interior(scores.inputs[1]):
            removed.add(kt_idx)

    # optional scale on q instead of on the scores: the q-side node is
    # KEPT as the fused node's q input (already feed-robust — it applies
    # the original constant to whatever is fed), only value-gated below
    q_prescaled = False
    if scale is None:
        prod_q = gv.producer.get(q_name)
        if prod_q is not None and gv.is_op(prod_q[1], "div", "mul") and \
                len(prod_q[1].inputs) == 2:
            qn, qd = prod_q[1].inputs[0], prod_q[1].inputs[1]
            sc = gv.scalar(qd)
            if prod_q[1].op == "mul" and sc is None:
                sc = gv.scalar(qn)
            if sc is not None:
                scale = (prod_q[1].op, sc[0], None)
                q_prescaled = True

    # ---- shape/value evidence ------------------------------------------
    qa = gv.aval(q_name)
    va = gv.aval(v_name)
    if qa is None or va is None or qa.rank not in (3, 4) or \
            va.rank != qa.rank:
        return None
    dk = qa.shape[-1]
    if not isinstance(dk, int) or dk <= 0:
        return None
    if k_shape is not None and len(k_shape) != qa.rank:
        return None
    if k_shape is not None and isinstance(k_shape[-1], int) \
            and k_shape[-1] != dk:
        return None
    if scale is not None:
        # pattern gate only: "is this the canonical attention scaling" —
        # the REWRITE never recomputes sqrt(dk) at runtime (dk evidence
        # may be placeholder-declared, and declarations are not enforced
        # at feed time), it re-applies the matched constant to q
        kind, val = scale[0], scale[1]
        want = float(np.sqrt(np.float32(dk)))
        ok = _close(val, want) if kind == "div" else _close(val, 1.0 / want)
        if not ok:
            return None
    else:
        scale = None

    # ---- build the fused node ------------------------------------------
    # scaled=False always: a matched scores-side scale becomes a
    # synthesized q-side node reusing the ORIGINAL constant — linearity
    # makes (q∘c) @ kᵀ ≡ (q @ kᵀ)∘c, and the numerics stay pinned to the
    # imported graph's own constant under any feed shape
    if scale is not None and not q_prescaled:
        pre = _Node_like(ctx, scale[0], [q_name, scale[2]], {},
                         [namer.fresh("qscale")])
        synth.append(pre)
        q_name = pre.outputs[0]
    inputs = [q_name, k_name, v_name]
    kwargs: Dict[str, Any] = {"scaled": False}
    mask_pending = None
    if mask is not None and mask[0] == "causal":
        kwargs["causal"] = True
    elif mask is not None:
        mask_pending = (mask[1], tuple(mask[2]))
    fused = _Node_like(ctx, "dot_product_attention", inputs, kwargs,
                       list(ctx.outputs))
    return removed, synth, fused, mask_pending


def _match_erf_gelu(gv: _GraphView, h_name: str):
    """Match the decomposed exact-gelu chain exporters emit downstream of a
    bias add: ``h * 0.5 * (1 + erf(h / sqrt(2)))`` in its canonical node
    order. Returns (removed_idxs, final_node) or None."""
    if gv.consumers.get(h_name, 0) != 2 or h_name in gv.external:
        return None
    div_entry = None
    for idx, n in gv.consumer_nodes(h_name):
        if gv.is_op(n, "div") and n.inputs[0] == h_name:
            sc = gv.scalar(n.inputs[1])
            if sc is not None and _close(sc[0], _SQRT2):
                div_entry = (idx, n)
        elif gv.is_op(n, "mul"):
            other = [i for i in n.inputs if i != h_name]
            sc = gv.scalar(other[0]) if len(other) == 1 else None
            if sc is not None and _close(sc[0], 1.0 / _SQRT2):
                div_entry = (idx, n)
    if div_entry is None:
        return None
    removed = {div_entry[0]}

    def step(name, want_op):
        nxt = gv.single_consumer(name)
        if nxt is None or not gv.is_op(nxt[1], want_op):
            return None
        return nxt

    erf = step(div_entry[1].outputs[0], "erf")
    if erf is None:
        return None
    removed.add(erf[0])
    add1 = step(erf[1].outputs[0], "add")
    if add1 is None:
        return None
    other = [i for i in add1[1].inputs if i != erf[1].outputs[0]]
    sc = gv.scalar(other[0]) if len(other) == 1 else None
    if sc is None or sc[0] != 1.0:
        return None
    removed.add(add1[0])
    mul_h = step(add1[1].outputs[0], "mul")
    if mul_h is None or h_name not in mul_h[1].inputs:
        return None
    removed.add(mul_h[0])
    half = step(mul_h[1].outputs[0], "mul")
    if half is None:
        return None
    other = [i for i in half[1].inputs if i != mul_h[1].outputs[0]]
    sc = gv.scalar(other[0]) if len(other) == 1 else None
    if sc is None or sc[0] != 0.5:
        return None
    removed.add(half[0])
    return removed, half[1]


def _try_epilogue(gv: _GraphView, add_idx: int, add):
    """Match ``act(x @ w + b)`` ending at the bias add (optionally plus an
    activation node or the decomposed erf-gelu chain).

    Returns ``(removed_idxs, fused_node)`` or None."""
    if not gv.is_op(add, "add") or len(add.inputs) != 2:
        return None
    for pos in (0, 1):
        prod = gv.producer.get(add.inputs[pos])
        if prod is None or not gv.is_op(prod[1], "mmul"):
            continue
        mm_idx, mm = prod
        if len(mm.inputs) != 2 or not gv.interior(mm.outputs[0]):
            continue
        b_name = add.inputs[1 - pos]
        ba = gv.aval(b_name)
        wa = gv.aval(mm.inputs[1])
        if ba is None or ba.rank != 1 or wa is None or wa.rank != 2:
            continue
        kwargs: Dict[str, Any] = {"activation": "none"}
        if mm.kwargs.get("transpose_a"):
            kwargs["transpose_a"] = True
        if mm.kwargs.get("transpose_b"):
            kwargs["transpose_b"] = True
        removed = {mm_idx, add_idx}
        out_node = add

        h_name = add.outputs[0]
        act = gv.single_consumer(h_name)
        if act is not None and gv.is_op(act[1], *_EPILOGUE_ACTS) and \
                len(act[1].inputs) == 1 and not act[1].kwargs:
            kwargs["activation"] = _EPILOGUE_ACTS[act[1].op]
            removed.add(act[0])
            out_node = act[1]
        else:
            gelu = _match_erf_gelu(gv, h_name)
            if gelu is not None:
                kwargs["activation"] = "gelu_exact"
                removed |= gelu[0]
                out_node = gelu[1]
        fused = _Node_like(add, "fused_matmul_bias_act",
                           [mm.inputs[0], mm.inputs[1], b_name], kwargs,
                           list(out_node.outputs))
        return removed, fused
    return None


_LN_OPS = ("layer_norm", "layer_norm_graph")


def _try_layernorm(gv: _GraphView, ln_idx: int, ln):
    """Match ``gelu(layer_norm(x, gain[, bias]))`` — a trailing-axis
    layer_norm whose single consumer is a gelu node (or the decomposed
    erf-gelu chain exporters emit) becomes ONE ``fused_layer_norm`` node
    (the JAX package's one-pass LN(+activation) kernel, still to be
    ported; the port runs the op's generic chain).
    Plain layer_norm without an activation is left verbatim — there is no
    epilogue to fuse.

    Returns ``(removed_idxs, fused_node)`` or None."""
    if not gv.is_op(ln, *_LN_OPS) or len(ln.inputs) not in (2, 3):
        return None
    xa = gv.aval(ln.inputs[0])
    if xa is None or xa.rank is None:
        return None
    axis = ln.kwargs.get("axis", -1)
    if axis not in (-1, xa.rank - 1):
        return None  # only trailing-axis norms map onto the fused kernel
    h_name = ln.outputs[0]
    removed = {ln_idx}
    # single_consumer enforces interior for the plain-gelu form;
    # _match_erf_gelu enforces its own exactly-two-consumers + non-output
    # contract for the decomposed chain (both branches of h feed the chain)
    act = gv.single_consumer(h_name)
    if act is not None and gv.is_op(act[1], "gelu") and \
            len(act[1].inputs) == 1 and not act[1].kwargs:
        activation = "gelu"
        removed.add(act[0])
        out_node = act[1]
    else:
        gelu = _match_erf_gelu(gv, h_name)
        if gelu is None:
            return None
        activation = "gelu_exact"
        removed |= gelu[0]
        out_node = gelu[1]
    fused = _Node_like(ln, "fused_layer_norm", list(ln.inputs),
                       {"axis": -1, "eps": ln.kwargs.get("eps", 1e-5),
                        "activation": activation},
                       list(out_node.outputs))
    return removed, fused


def _pass_workspace(nodes, const_vals, var_shapes, seed_dtypes,
                    input_avals, local_ops):
    """(avals, namer) for one fusion pass application: the
    abstract-interpreter evidence plus a fresh-name generator seeded with
    every name the working graph can see."""
    avals = _abstract_avals(nodes, const_vals, var_shapes, seed_dtypes,
                            input_avals, local_ops)
    taken = set(avals)
    for n in nodes:
        taken.update(n.outputs)
        taken.update(n.inputs)
    return avals, _Namer(taken)


def _fusion(nodes, outputs, const_vals, var_shapes, seed_dtypes,
            input_avals, alias, local_ops, stats):
    """The fusion tier: attention first (its chain contains matmuls the
    epilogue matcher must not claim), then matmul epilogues, then
    layer_norm(+gelu) chains, one linear scan each. Rewrites splice in
    place: removed nodes drop out, synthesized nodes land immediately
    before the fused node, output names are preserved so downstream
    consumers (and the alias map) never move."""
    # every pattern anchors on a catalog mmul or layer_norm; graphs with
    # neither (conv nets, elementwise chains, most train steps) skip the
    # abstract interpretation entirely — fusion is on the default compile
    # path
    if not any(n.op not in local_ops and (n.op == "mmul" or n.op in _LN_OPS)
               for n in nodes):
        return nodes, False
    avals, namer = _pass_workspace(nodes, const_vals, var_shapes,
                                   seed_dtypes, input_avals, local_ops)
    changed = False

    for matcher, kind in ((_try_attention, "attention"),
                          (_try_epilogue, "epilogue"),
                          (_try_layernorm, "layernorm")):
        gv = _GraphView(nodes, outputs, alias, const_vals, avals, local_ops)
        mask_cache: Dict[Any, str] = {}
        rewrites = {}   # anchor idx -> (removed, synth, fused)
        claimed: set = set()
        for idx, n in enumerate(nodes):
            if n.op in local_ops:
                continue
            if matcher is _try_attention:
                m = matcher(gv, idx, n, namer)
                if m is None:
                    continue
                removed, synth, fused, mask_pending = m
            else:
                m = matcher(gv, idx, n)
                if m is None:
                    continue
                removed, fused = m
                synth, mask_pending = [], None
            if removed & claimed:
                continue  # overlaps an accepted match: discard whole
            claimed |= removed
            if mask_pending is not None:
                # synthesize/cache the mask expansion mirror only for
                # ACCEPTED matches — a discarded match must never leave a
                # cache entry whose defining nodes were not spliced in
                m_final = mask_cache.get(mask_pending)
                if m_final is None:
                    mask_name, expand_axes = mask_pending
                    m_final = mask_name
                    for ax in expand_axes:
                        nd = _Node_like(fused, "expand_dims", [m_final],
                                        {"axis": ax}, [namer.fresh("mask")])
                        synth.append(nd)
                        m_final = nd.outputs[0]
                    mask_cache[mask_pending] = m_final
                fused.inputs.append(m_final)
            rewrites[idx] = (removed, synth, fused)
            stats.record_fusion(kind)
        if rewrites:
            out_nodes = []
            all_removed = set()
            for removed, _s, _f in rewrites.values():
                all_removed |= removed
            for idx, n in enumerate(nodes):
                if idx in rewrites:
                    removed, synth, fused = rewrites[idx]
                    out_nodes.extend(synth)
                    out_nodes.append(fused)
                elif idx not in all_removed:
                    out_nodes.append(n)
            nodes = out_nodes
            changed = True
    return nodes, changed


# ---------------------------------------------------------------------------
# pass-invariance checking
# ---------------------------------------------------------------------------


class _InvariantChecker:
    """Abstract-interpret the working node list and compare the interface
    (requested-output) shapes/dtypes against the pre-pipeline snapshot.

    Every pass must be shape/dtype-preserving; a provable change (both the
    snapshot and the current value concrete, and different) raises
    :class:`~deeplearning4j_tpu_torch.analysis.PassInvariantError` naming
    the pass that introduced the miscompile. Symbolic/unknown entries are
    skipped — soundness over coverage."""

    def __init__(self, outputs, input_avals, var_shapes, seed_dtypes,
                 local_ops, stats):
        from deeplearning4j_tpu_torch import analysis as _an

        self._an = _an
        self.outputs = list(outputs)
        self.local_ops = local_ops
        self.stats = stats
        self.baseline: Dict[str, Any] = {}
        # the non-const seed never changes across passes — build it once
        self._static_seed: Dict[str, Any] = {}
        for n, s in (var_shapes or {}).items():
            self._static_seed[n] = _an.AVal(
                shape=tuple(s), dtype=(seed_dtypes or {}).get(n))
        for n, dt in (seed_dtypes or {}).items():
            if n not in self._static_seed:
                self._static_seed[n] = _an.AVal(dtype=dt)
        for n, a in (input_avals or {}).items():
            self._static_seed.setdefault(n, a)
        # const_vals only ever GROWS (fold adds, nothing removes): abstract
        # each value once instead of re-copying every <=4096-element
        # constant to host on every verify call
        self._const_avals: Dict[str, Any] = {}

    def _interface(self, work, const_vals, alias) -> Dict[str, Any]:
        an = self._an
        for n, v in const_vals.items():
            if n not in self._const_avals:
                self._const_avals[n] = an.AVal.of_array(
                    v, keep_value=v.numel() <= 4096)
        avals: Dict[str, Any] = dict(self._static_seed)
        avals.update(self._const_avals)
        an.infer_nodes(list(enumerate(work)), avals, self.local_ops,
                       graph_name="<optimizer>", findings=[])
        return {o: avals.get(_resolve(alias, o), an.AVal.unknown())
                for o in self.outputs}

    def snapshot(self, work, const_vals, alias) -> None:
        self.baseline = self._interface(work, const_vals, alias)

    def verify(self, pass_name, work, const_vals, alias) -> None:
        an = self._an
        current = self._interface(work, const_vals, alias)
        self.stats.invariant_checks += 1
        for out, before in self.baseline.items():
            after = current[out]
            if before.dtype is not None and after.dtype is not None \
                    and before.dtype != after.dtype:
                raise an.PassInvariantError(pass_name, out, "dtype",
                                            before.dtype, after.dtype)
            if before.shape is None or after.shape is None:
                continue
            if len(before.shape) != len(after.shape):
                raise an.PassInvariantError(pass_name, out, "rank",
                                            before.shape, after.shape)
            for db, da in zip(before.shape, after.shape):
                if isinstance(db, int) and isinstance(da, int) and db != da:
                    raise an.PassInvariantError(pass_name, out, "shape",
                                                before.shape, after.shape)


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------


def optimize_graph(nodes, outputs: Sequence[str], *,
                   const_env: Dict[str, Any],
                   seed_dtypes: Optional[Dict[str, Any]] = None,
                   var_shapes: Optional[Dict[str, Tuple[int, ...]]] = None,
                   local_ops: Optional[Dict[str, Callable]] = None,
                   resolve_op: Optional[Callable[[str], Callable]] = None,
                   passes: Optional[Sequence[str]] = None,
                   fold_size_limit: int = FOLD_SIZE_LIMIT,
                   precision_policy: str = "float32",
                   max_iters: int = _MAX_ITERS,
                   input_avals: Optional[Dict[str, Any]] = None,
                   check_invariants: bool = True) -> GraphPlan:
    """Run the enabled passes over ``nodes`` until a fixpoint.

    Pure with respect to the inputs: ``nodes`` entries are copied, and
    ``const_env`` is never mutated (folded values land in
    ``GraphPlan.extra_consts``). ``passes=None`` enables all of
    :data:`PASS_ORDER`; pass an explicit subset for per-pass control.

    ``check_invariants`` (default on): after every pass application the
    abstract interpreter re-derives the interface shapes/dtypes of the
    requested outputs and compares them to the pre-pipeline snapshot —
    a pass that provably changes one (a bad transpose composition, a
    dtype-unsound strip) raises PassInvariantError AT THE PASS that
    introduced it, instead of shipping a miscompiled plan.
    ``input_avals``: symbolic placeholder avals (name -> analysis.AVal)
    so named batch dims survive into the invariance check.
    """
    t0 = time.perf_counter()
    local_ops = local_ops or {}
    if resolve_op is None:
        from deeplearning4j_tpu_torch.autodiff import samediff as _sd

        def resolve_op(name, _lo=local_ops):
            return _sd.resolve_graph_op(name, _lo)
    enabled = tuple(passes) if passes is not None else PASS_ORDER
    if any(p in _NOT_PORTED_PASSES for p in enabled):
        raise NotImplementedError(_AUTOCAST_NOT_PORTED)
    valid = PASS_ORDER
    unknown = [p for p in enabled if p not in valid]
    if unknown:
        raise ValueError(f"unknown optimizer pass(es) {unknown}; "
                         f"valid: {list(valid)}")

    alias: Dict[str, str] = {}
    const_vals = dict(const_env)
    work = [_copy_node(n) for n in nodes]
    stats = OptimizeStats(nodes_before=len(work))

    checker = None
    if check_invariants:
        checker = _InvariantChecker(outputs, input_avals, var_shapes,
                                    seed_dtypes, local_ops, stats)
        checker.snapshot(work, const_vals, alias)

    for _ in range(max_iters):
        changed = False
        for p in PASS_ORDER:
            if p not in enabled:
                continue
            before = len(work)
            if p == "dce":
                work, ch = _dce(work, outputs, alias)
            elif p == "fold":
                work, ch = _fold(work, const_vals, resolve_op, local_ops,
                                 fold_size_limit, precision_policy)
            elif p == "cse":
                work, ch = _cse(work, alias, local_ops)
            elif p == "fusion":
                work, ch = _fusion(work, outputs, const_vals,
                                   var_shapes or {}, seed_dtypes or {},
                                   input_avals, alias, local_ops, stats)
            else:
                work, ch = _algebraic(work, const_vals, var_shapes or {},
                                      seed_dtypes or {}, alias, local_ops)
            ch |= _rewrite_inputs(work, alias)
            stats.record_pass(p, before, len(work))
            if ch and checker is not None:
                # every pass must preserve the interface shapes/dtypes;
                # verify against the pre-pipeline snapshot so the FIRST
                # deviating pass is the one named in the error
                checker.verify(p, work, const_vals, alias)
            changed |= ch
        if not changed:
            break

    referenced = {i for n in work for i in n.inputs}
    referenced.update(_resolve(alias, o) for o in outputs)
    extra = {k: v for k, v in const_vals.items()
             if k not in const_env and k in referenced}
    stats.nodes_after = len(work)
    t1 = time.perf_counter()
    stats.optimize_seconds = t1 - t0
    # telemetry: count the pipeline runs, their seconds and the fusion-tier
    # hits (labelled family: kind=attention|epilogue|layernorm)
    from deeplearning4j_tpu_torch import observe

    m = observe.metrics()
    m.counter("dl4j_tpu_graph_optimizations_total").inc()
    m.histogram("dl4j_tpu_graph_optimize_seconds").observe(
        stats.optimize_seconds)
    for kind, hits in stats.fusions.items():
        m.counter("dl4j_tpu_graph_fusions_total", kind=kind).inc(hits)
    return GraphPlan(nodes=work, extra_consts=extra, alias=alias,
                     outputs=list(outputs), stats=stats)


# ---------------------------------------------------------------------------
# compiled execution (the trace/compile split of last_compile_stats)
# ---------------------------------------------------------------------------


class CompiledGraph:
    """The counterpart of the reference's ``CompiledGraph(jax.jit(run))``:
    ``run(var_arrays, feeds) -> {name: tensor}``, the eager whole-graph
    function, as a :class:`~deeplearning4j_tpu_torch.ops.capture.CapturedUnit`
    — on the card captured once per feed signature (the variables and feeds
    by name, shape and dtype) and replayed after; on the CPU, or under
    ``disable_capture()``, run eagerly each call. The outputs are the
    graph's own buffers, good until the next call.

    Its first call is timed as the reference times it: the warm-up run as
    ``stats.trace_seconds``, the capture as ``stats.compile_seconds``, with
    the ``jit_trace`` / ``xla_compile`` spans and the
    ``dl4j_tpu_trace_seconds`` / ``dl4j_tpu_xla_compile_seconds``
    histograms. A first call that captures nothing (the CPU) is all trace:
    ``compile_seconds`` stays None. A graph with an :attr:`eager_reason`
    is never captured: each call runs eagerly, recorded as routed."""

    def __init__(self, run: Callable[..., Dict[str, torch.Tensor]],
                 stats: Optional[OptimizeStats] = None, *, device):
        from deeplearning4j_tpu_torch.ops.capture import CapturedUnit

        self._run = run
        self.stats = stats if stats is not None else OptimizeStats()
        self._timed = False
        self._names: Tuple[Tuple[str, ...], Tuple[str, ...]] = ((), ())
        self.unit = CapturedUnit(self._flat, device=device, name="exec")
        # the routing rule's reason when the graph must run eagerly (a
        # node reads the host: nn/compiled.py CONTROL_FLOW), else None
        self.eager_reason: Optional[str] = None

    def _flat(self, *tensors):
        var_names, feed_names = self._names
        n = len(var_names)
        return self._run(dict(zip(var_names, tensors[:n])),
                         dict(zip(feed_names, tensors[n:])))

    def __call__(self, var_arrays: Dict[str, torch.Tensor],
                 feeds: Dict[str, torch.Tensor],
                 signature: str = "") -> Dict[str, torch.Tensor]:
        self._names = (tuple(sorted(var_arrays)), tuple(sorted(feeds)))
        args = ([var_arrays[k] for k in self._names[0]]
                + [feeds[k] for k in self._names[1]])
        if self.eager_reason is not None:
            run = lambda *a, key: self._routed(signature, *a)  # noqa: E731
        else:
            run = self.unit
        if self._timed:
            with torch.no_grad():
                return run(*args, key=self._names)
        self._timed = True
        captures = self.unit.captures
        t0 = time.perf_counter()
        with torch.no_grad():
            out = run(*args, key=self._names)
        t_end = time.perf_counter()
        from deeplearning4j_tpu_torch import observe

        tr, m = observe.tracer(), observe.metrics()
        if self.unit.captures > captures:
            t0, t1, t2 = self.unit.timings
            self.stats.trace_seconds = round(t1 - t0, 4)
            self.stats.compile_seconds = round(t2 - t1, 4)
            tr.complete_between("jit_trace", t0, t1, category="compile")
            tr.complete_between("xla_compile", t1, t2, category="compile")
            m.histogram("dl4j_tpu_trace_seconds").observe(t1 - t0)
            m.histogram("dl4j_tpu_xla_compile_seconds").observe(t2 - t1)
        else:
            self.stats.trace_seconds = round(t_end - t0, 4)
            tr.complete_between("jit_trace", t0, t_end, category="compile")
            m.histogram("dl4j_tpu_trace_seconds").observe(t_end - t0)
        return out

    def _routed(self, signature: str, *args):
        """A call routed to eager by :attr:`eager_reason`: recorded once per
        signature in the ledger, counted in
        ``dl4j_tpu_capture_skipped_total{unit="exec",reason}``."""
        from deeplearning4j_tpu_torch import observe

        observe.ledger().routed(graph="samediff", key="exec",
                                signature=signature, reason=self.eager_reason)
        observe.metrics().counter("dl4j_tpu_capture_skipped_total",
                                  unit="exec",
                                  reason=self.eager_reason).inc()
        return self._flat(*args)

    def reset(self) -> None:
        """Drop the captured graphs and their pool."""
        self.unit.reset()
