"""SameDiff graphs and the graph optimizer of the port.

Counterpart of ``deeplearning4j_tpu/autodiff``: :mod:`.samediff` (the
graph, its op catalog, eager execution, gradients, ``fit``, control flow
and ``save`` / ``load``), :mod:`.optimize` (the pre-run pass pipeline and
its fusion tier), :mod:`.listeners` (History), :mod:`.gradcheck`
(finite differences in float64) and :mod:`.export` (the AOT export
cache). The JAX package's ``check_gradients`` for networks and its
``UIListener`` are not ported yet (ROADMAP.md, Queue 1 items 13 and 10).
"""

from deeplearning4j_tpu_torch.autodiff.samediff import (
    GRAPH_OPS, SameDiff, SDVariable, TrainingConfig, resolve_graph_op,
)

from deeplearning4j_tpu_torch.autodiff.gradcheck import (
    check_gradients_fn, check_samediff_gradients,
)
from deeplearning4j_tpu_torch.autodiff.listeners import (
    History, HistoryListener,
)
from deeplearning4j_tpu_torch.autodiff.optimize import (
    GraphPlan, OptimizeStats, optimize_graph,
)

__all__ = ["GRAPH_OPS", "SameDiff", "SDVariable", "TrainingConfig",
           "resolve_graph_op", "GraphPlan", "OptimizeStats",
           "optimize_graph", "check_gradients_fn",
           "check_samediff_gradients", "History", "HistoryListener"]
