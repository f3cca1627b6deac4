"""Graph-check reports: the GC codes, the findings' record, the report of
one check and its raise policy.

Counterpart of ``deeplearning4j_tpu/analysis/report.py``. The JAX package
records a finding in its lint ``Finding``; the port keeps the same five
fields in its own :class:`~.findings.Finding` (path, line, rule, severity,
message), so a report's codes and positions compare one for one with the
JAX package's. For a graph finding:

* ``path`` — the logical graph name (``onnx:bert_base``,
  ``keras:functional`` …);
* ``line`` — the 1-based node position in the recording;
* ``message`` — leads with the node: op name and the node's output name,
  which for imported graphs is the source graph's node name.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from deeplearning4j_tpu_torch.analysis.findings import (
    GC_CODES, Finding, PassInvariantError, make_finding,
)

__all__ = ["CheckReport", "GC_CODES", "GraphCheckError", "PassInvariantError",
           "make_finding"]


class GraphCheckError(ValueError):
    """Raised when a checked graph carries error-severity findings."""

    def __init__(self, findings: List[Finding]):
        self.findings = list(findings)
        lines = [f.render() for f in self.findings[:20]]
        extra = len(self.findings) - len(lines)
        if extra > 0:
            lines.append(f"... and {extra} more")
        super().__init__(
            "graftcheck: graph failed static shape/dtype verification "
            f"({len(self.findings)} error finding"
            f"{'s' if len(self.findings) != 1 else ''}):\n"
            + "\n".join(lines))


class CheckReport:
    """Result of one graph check: the findings, sorted, the inferred
    abstract values (name -> AVal) and the check's wall seconds."""

    def __init__(self, graph_name: str, findings: List[Finding],
                 avals: Optional[Dict[str, object]] = None,
                 seconds: float = 0.0):
        self.graph_name = graph_name
        self.findings = sorted(findings)
        self.avals = avals or {}
        self.seconds = seconds

    @property
    def errors(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == "error"]

    @property
    def warnings(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == "warning"]

    @property
    def ok(self) -> bool:
        return not self.errors

    def raise_on_errors(self) -> "CheckReport":
        if self.errors:
            raise GraphCheckError(self.errors)
        return self

    def render(self) -> str:
        if not self.findings:
            return f"graftcheck: {self.graph_name}: clean"
        return "\n".join(f.render() for f in self.findings)

    def __repr__(self) -> str:
        return (f"CheckReport({self.graph_name!r}, "
                f"{len(self.errors)} errors, {len(self.warnings)} warnings)")
