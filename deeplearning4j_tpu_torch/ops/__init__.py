"""Op registry of the port: generic PyTorch ops and their CUDA kernels.

Importing this package registers the generic ops (:mod:`.nn_ops`) and
installs the hand-written CUDA kernels as their ``"cuda"`` platform
helpers (:mod:`.cuda_attention`). No kernel is built at import.
"""

from deeplearning4j_tpu_torch.ops import nn_ops  # noqa: F401 (registers)
from deeplearning4j_tpu_torch.ops.cuda_attention import (
    register_platform_attention,
)
from deeplearning4j_tpu_torch.ops.registry import (
    OpDescriptor, OpRegistry, exec_op, op, registry,
)

register_platform_attention()

__all__ = ["OpDescriptor", "OpRegistry", "exec_op", "op", "registry"]
