"""Shape ops of the port.

Counterpart of the part of ``deeplearning4j_tpu/ops/shape_ops.py`` the
ResNet-50 stem reaches: ``space_to_depth`` (``shape_ops.py:222``).
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.ops.registry import op


@op("space_to_depth")
def space_to_depth(x, *, block_size: int, data_format: str = "NHWC"):
    """space_to_depth (generic/parity_ops/space_to_depth.cpp): each b×b
    block of pixels becomes b·b·C channels, in (row, col, channel) order."""
    if data_format == "NCHW":
        x = x.permute(0, 2, 3, 1)
    n, h, w, c = x.shape
    b = block_size
    x = x.reshape(n, h // b, b, w // b, b, c).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(n, h // b, w // b, b * b * c)
    if data_format == "NCHW":
        x = x.permute(0, 3, 1, 2)
    return x
