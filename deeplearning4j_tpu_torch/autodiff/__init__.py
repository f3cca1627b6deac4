"""SameDiff graphs and the graph optimizer of the port.

Counterpart of ``deeplearning4j_tpu/autodiff``: :mod:`.samediff` (the
graph, its op catalog, eager execution, gradients and ``fit``),
:mod:`.optimize` (the pre-run pass pipeline and its fusion tier),
:mod:`.listeners` (History) and :mod:`.gradcheck` (finite differences in
float64). Control flow, serde and export are not ported yet (ROADMAP.md,
Queue 1 item 6).
"""

from deeplearning4j_tpu_torch.autodiff.samediff import (
    GRAPH_OPS, SameDiff, SDVariable, TrainingConfig, resolve_graph_op,
)

__all__ = ["GRAPH_OPS", "SameDiff", "SDVariable", "TrainingConfig",
           "resolve_graph_op"]
