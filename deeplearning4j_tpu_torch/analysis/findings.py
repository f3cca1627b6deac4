"""Findings of the shape/dtype evidence walk, and the optimizer's
pass-invariance error.

The JAX package records graph findings in its lint ``Finding`` and builds
reports, baselines and a CLI on them (``deeplearning4j_tpu/analysis/
report.py``). The port runs the walk only as the optimizer's evidence and
invariant checker, so it keeps a small record of its own; the report, the
CLI and ``check_samediff`` are not ported (ROADMAP.md, Queue 1 item 10).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

# code -> (severity, one-line title). Errors are PROVABLE misimports or
# miscompiles; warnings are opacity/precision hazards.
GC_CODES: Dict[str, Tuple[str, str]] = {
    "GC001": ("error", "rank mismatch / invalid axis"),
    "GC002": ("error", "broadcast or contraction failure"),
    "GC003": ("warning", "dtype promotion surprise"),
    "GC004": ("error", "unbound placeholder / dangling input"),
    "GC005": ("error", "reshape element-count mismatch"),
    "GC006": ("warning", "unknown-op opacity"),
}


@dataclasses.dataclass(frozen=True, order=True)
class Finding:
    """One finding: the graph's name, the 1-based node position, the GC
    code, its severity and a message that leads with the node."""

    path: str
    line: int
    rule: str
    severity: str
    message: str

    def render(self) -> str:
        return (f"{self.path}:{self.line}: {self.rule} {self.severity}: "
                f"{self.message}")


def make_finding(graph_name: str, node_index: int, code: str,
                 message: str) -> Finding:
    severity, _title = GC_CODES[code]
    return Finding(path=graph_name, line=node_index + 1, rule=code,
                   severity=severity, message=message)


class PassInvariantError(RuntimeError):
    """An optimizer pass changed an interface shape/dtype it must preserve
    (``autodiff/optimize.py`` runs the walk between passes)."""

    def __init__(self, pass_name: str, output: str, kind: str,
                 before, after):
        self.pass_name = pass_name
        self.output = output
        super().__init__(
            f"optimizer pass '{pass_name}' changed the {kind} of graph "
            f"output '{output}': {before} -> {after} — the pass pipeline "
            f"must be shape/dtype-preserving; disable it via "
            f"SameDiff(optimize_passes=...) and report the miscompile")
