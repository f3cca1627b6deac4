"""Shape/dtype evidence over SameDiff node lists.

The part of ``deeplearning4j_tpu/analysis`` that the graph optimizer
reads: the abstract domain (:class:`AVal`, :class:`Dim`), symbolic
broadcasting and the JAX package's dtype promotion, the per-op rules and
the walk (:func:`infer_nodes`). The fusion matchers take their evidence
from it and the pass-invariance checker re-derives the interface
shapes/dtypes with it after every pass (``autodiff/optimize.py``).
Graph checking as a user feature (``SameDiff.check``, ``validate=True``,
reports, the CLI) is not ported yet (ROADMAP.md, Queue 1 item 10).
"""

from deeplearning4j_tpu_torch.analysis.findings import (
    GC_CODES, Finding, PassInvariantError,
)
from deeplearning4j_tpu_torch.analysis.interpreter import infer_nodes
from deeplearning4j_tpu_torch.analysis.values import AVal, Dim, as_dtype

__all__ = ["AVal", "Dim", "Finding", "GC_CODES", "PassInvariantError",
           "as_dtype", "infer_nodes"]
