"""Framework-neutral import IR — the samediff-import framework analog.

Counterpart of ``deeplearning4j_tpu/imports/ir.py``: a front end lowers a
source graph into :class:`IRGraph`, and :class:`IRImporter` owns the
shared walk (initializers → variables/constants, placeholders,
topological rule dispatch, output renaming) that builds a port
:class:`~deeplearning4j_tpu_torch.autodiff.samediff.SameDiff` on the
importer's device (the card unless the caller passes ``device="cpu"``).

The JAX walker checks the finished graph statically by default
(``validate=True``, its analyzers' ``check_samediff``). That check is not
ported yet (ROADMAP.md, Queue 1 item 10): here ``validate`` defaults to
False and ``validate=True`` raises rather than silently checking nothing.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from deeplearning4j_tpu_torch.autodiff.samediff import (
    VALIDATE_NOT_PORTED, SameDiff, SDVariable,
)


@dataclasses.dataclass
class IRNode:
    """One computation node, framework-normalized."""

    name: str
    op_type: str
    inputs: List[str]
    outputs: List[str]
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)

    # back-compat shim: TF mappers historically read node.input[i]
    @property
    def input(self) -> List[str]:
        return self.inputs


# "slice to the end" sentinel shared by the slice rules: the strided_slice
# op clamps out-of-range bounds, as Python slicing does.
SLICE_TO_END = 2**31 - 1


@dataclasses.dataclass
class IRGraph:
    """Normalized graph: nodes in topological-ish file order + tensors."""

    nodes: List[IRNode]
    initializers: Dict[str, np.ndarray]
    inputs: List[Tuple[str, Optional[Tuple[Optional[int], ...]]]]
    outputs: List[str]
    name: str = "imported"


class IRImporter:
    """Shared rule-dispatch walker (MappingProcess executor analog).

    ``rules``: op_type -> fn(sd, ins, attrs, node, const_values=...) -> SDVariable.
    Rules listed in ``needs_consts`` additionally receive the raw numpy
    values of constant operands (shape/perm/axis inputs). ``device``: where
    the imported SameDiff keeps its arrays.
    """

    def __init__(self, rules: Dict[str, Callable[..., Any]],
                 needs_consts: Sequence[str] = (),
                 trainable_consts: bool = True,
                 needs_scope: Sequence[str] = (),
                 optimize: bool = True,
                 validate: bool = False,
                 device: Union[str, torch.device, None] = None):
        if validate:
            raise NotImplementedError(VALIDATE_NOT_PORTED)
        self.rules = dict(rules)
        self.needs_consts = set(needs_consts)
        self.trainable_consts = trainable_consts
        # ops whose rule receives scope= (the live name→SDVariable map built
        # so far) — ONNX Loop/If/Scan subgraphs capture outer-scope tensors
        # by name, unlike TF function-style control flow
        self.needs_scope = set(needs_scope)
        # the graph optimizer (autodiff/optimize.py): imported graphs carry
        # the most redundancy (verbatim source nodes, per-layer duplicated
        # chains, no-op Identity/Dropout), so every frontend that lowers
        # through this walker gets it by default — including the fusion
        # tier that routes attention/matmul-epilogue chains onto the
        # hand-written kernels (optimize=False opts out)
        self.optimize = optimize
        self.validate = validate
        self.device = device

    def supported_ops(self) -> List[str]:
        return sorted(self.rules)

    def run_import(self, ir: IRGraph) -> SameDiff:
        sd = SameDiff.create(optimize=self.optimize, device=self.device)
        produced: Dict[str, SDVariable] = {}
        const_values: Dict[str, np.ndarray] = dict(ir.initializers)

        for name, arr in ir.initializers.items():
            if (self.trainable_consts and
                    np.issubdtype(arr.dtype, np.floating) and arr.size > 1):
                produced[name] = sd.var(name, arr)
            else:
                produced[name] = sd.constant(name, arr)
        for name, shape in ir.inputs:
            produced[name] = sd.placeholder(name, shape=shape)

        for node in ir.nodes:
            rule = self.rules.get(node.op_type)
            if rule is None:
                raise NotImplementedError(
                    f"op '{node.op_type}' (node {node.name}) has no mapping "
                    f"rule; register one in the {ir.name} dialect table")
            # empty names are ONNX's explicit "optional input absent" slots
            missing = [n for n in node.inputs if n and n not in produced]
            if missing:
                # a silently dropped operand would misalign the positional
                # `ins` and surface as an arity error far from the cause —
                # typically an unregistered multi-output slot (e.g. a mapper
                # that returns fewer outputs than the source op produces)
                raise ValueError(
                    f"node '{node.name}' ({node.op_type}) consumes "
                    f"unresolved input(s) {missing} — its producer's mapping "
                    f"rule may not register that output slot")
            ins = [produced[n] for n in node.inputs if n]
            kw = {}
            if node.op_type in self.needs_consts:
                kw["const_values"] = const_values
            if node.op_type in self.needs_scope:
                kw["scope"] = produced
            out = rule(sd, ins, node.attrs, node, **kw)
            if out is None:
                continue
            outs = out if isinstance(out, (list, tuple)) else [out]
            names = node.outputs or [node.name]
            for o, oname in zip(outs, names):
                if o.vtype == "ARRAY" and oname not in sd._vars:
                    o.rename(oname)
                produced[oname] = o
            # extra outputs beyond the declared names resolve by slot — the
            # TF "op:N" addressing (graphdef_to_ir preserves N > 0 slots)
            for j in range(len(names), len(outs)):
                produced[f"{node.name}:{j}"] = outs[j]
            # the node's own name also resolves (TF addressing convention)
            produced.setdefault(node.name, outs[0])
        # record the graph IO signature (GraphRunner uses it for default
        # fetches; TF GraphDefs carry no explicit outputs → terminal nodes)
        outs = list(ir.outputs)
        if not outs:
            consumed = {i for node in ir.nodes for i in node.inputs}
            # only nodes that actually produced a value — rules may return
            # None for utility nodes (NoOp/init), which never materialize
            outs = [n.name for n in ir.nodes
                    if n.name not in consumed and n.name in produced]
        for oname in outs:
            if oname not in sd._vars and oname in produced:
                # output name resolves to a var that could not be renamed
                # (a placeholder passthrough, e.g. a While body returning a
                # loop-invariant arg via Identity) — alias it explicitly so
                # execution can fetch it by the graph's output name
                sd._record("identity", [produced[oname]]).rename(oname)
        sd.graph_inputs = [n for n, _ in ir.inputs]
        sd.graph_outputs = outs
        return sd
