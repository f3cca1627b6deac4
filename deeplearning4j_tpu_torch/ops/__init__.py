"""Op registry of the port: generic PyTorch ops and their CUDA kernels.

Importing this package registers the generic ops (:mod:`.nn_ops`,
:mod:`.shape_ops`, :mod:`.quantized`, ``fused_updater_step``,
``fused_bn_matmul_stats``, ``lstm_layer``) and installs the hand-written
CUDA kernels as their ``"cuda"`` platform helpers (:mod:`.cuda_attention`,
:mod:`.cuda_updater`, :mod:`.cuda_convbn`, :mod:`.cuda_matmul`,
:mod:`.cuda_layernorm`, :mod:`.cuda_quantized`), and cuDNN's LSTM as
``lstm_layer``'s (:mod:`.cudnn_lstm`, a library call: the reference has
no TPU kernel there). No kernel is built at import.
"""

from deeplearning4j_tpu_torch.ops import nn_ops, quantized, shape_ops  # noqa: F401
from deeplearning4j_tpu_torch.ops.cuda_attention import (
    register_platform_attention,
)
from deeplearning4j_tpu_torch.ops.cuda_convbn import register_platform_convbn
from deeplearning4j_tpu_torch.ops.cuda_layernorm import (
    register_platform_fused_layernorm,
)
from deeplearning4j_tpu_torch.ops.cuda_matmul import (
    register_platform_fused_matmul,
)
from deeplearning4j_tpu_torch.ops.cuda_quantized import (
    register_platform_quantized,
)
from deeplearning4j_tpu_torch.ops.cuda_updater import (
    register_platform_fused_updater,
)
from deeplearning4j_tpu_torch.ops.cudnn_lstm import register_platform_lstm
from deeplearning4j_tpu_torch.ops.registry import (
    OpDescriptor, OpRegistry, exec_op, op, registry,
)

register_platform_attention()
register_platform_fused_updater()
register_platform_convbn()
register_platform_fused_matmul()
register_platform_fused_layernorm()
register_platform_quantized()
register_platform_lstm()

__all__ = ["OpDescriptor", "OpRegistry", "exec_op", "op", "registry"]
