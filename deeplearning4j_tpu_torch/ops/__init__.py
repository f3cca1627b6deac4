"""Op registry of the port: generic PyTorch ops and their CUDA kernels.

Importing this package registers the op catalog — the JAX registry's 285
ops under their names (:mod:`.transforms`, :mod:`.reductions`,
:mod:`.shape_ops`, :mod:`.misc_ops`, :mod:`.scatter`, :mod:`.linalg_ops`,
:mod:`.image_ops`, :mod:`.bitwise`, :mod:`.random`, :mod:`.compression`,
:mod:`.nn_ops`, :mod:`.quantized`, ``fused_updater_step``) and the port's
own ``fused_bn_matmul_stats`` and ``lstm_layer`` — with a validation spec
for each (:mod:`.validation`, :mod:`.nn_cases`), and installs the
hand-written CUDA kernels as their ``"cuda"`` platform helpers
(:mod:`.cuda_attention`, :mod:`.cuda_updater`, :mod:`.cuda_convbn`,
:mod:`.cuda_matmul`, :mod:`.cuda_layernorm`, :mod:`.cuda_quantized`), and
cuDNN's LSTM as ``lstm_layer``'s (:mod:`.cudnn_lstm`, a library call: the
reference has no TPU kernel there). No kernel is built at import.
"""

from deeplearning4j_tpu_torch.ops import (  # noqa: F401
    bitwise, compression, image_ops, linalg_ops, misc_ops, nn_cases, nn_ops,
    quantized, random, reductions, scatter, shape_ops, transforms, validation,
)
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
