"""graftcheck — the abstract shape/dtype interpreter over SameDiff graphs
and layer-level networks.

Counterpart of ``deeplearning4j_tpu/analysis``. The abstract domain
(:class:`AVal`, :class:`Dim`), symbolic broadcasting and the JAX
package's dtype promotion, the per-op rules and the walk
(:func:`infer_nodes`) are the graph optimizer's evidence and its
pass-invariance checker (``autodiff/optimize.py``). The checks:

* ``SameDiff.check()`` / ``SameDiff(validate=True)`` — the user surface;
* :func:`check_samediff` / :func:`check_network` — direct calls;
* every importer (ONNX, TF, IR, Keras) runs the check after importing
  unless it is given ``validate=False``.

Not ported yet: the CLI, the fixture zoo and ``__main__`` (ROADMAP.md,
Queue 1 item 11).
"""

from deeplearning4j_tpu_torch.analysis.findings import (
    GC_CODES, Finding, PassInvariantError,
)
from deeplearning4j_tpu_torch.analysis.interpreter import (
    check_samediff, infer_nodes, seed_avals,
)
from deeplearning4j_tpu_torch.analysis.network import check_network
from deeplearning4j_tpu_torch.analysis.report import (
    CheckReport, GraphCheckError,
)
from deeplearning4j_tpu_torch.analysis.values import AVal, Dim, as_dtype

# the one-call spelling used by importers and docs
check = check_samediff

__all__ = ["AVal", "CheckReport", "Dim", "Finding", "GC_CODES",
           "GraphCheckError", "PassInvariantError", "as_dtype", "check",
           "check_network", "check_samediff", "infer_nodes", "seed_avals"]
