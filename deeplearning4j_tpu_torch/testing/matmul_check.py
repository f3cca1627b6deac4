"""Faulted plain versions of the fused matmul, for the check of the
tensor-core ("sm90") kernel.

``csrc/fused_matmul_sm90.cu`` walks K in slabs of :data:`SLAB` columns
through a ring of shared-memory stages. The faults such a design could
bring are a slab that never reaches the product (the last, ragged one) and
a slab that is accumulated twice (a consumer waiting on the wrong phase of
its stage's barrier). :func:`fused_matmul_variant` computes the plain
version (``cuda_matmul.fused_matmul_bias_act_reference``) with one of
these faults; each must exceed ``cuda_matmul.kernel_tolerance``, which
shows that the kernel's check still catches them.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.ops.nn_ops import apply_fused_activation

SLAB = 64  # K columns of one shared-memory stage
FAULTS = ("last_slab_dropped", "slab_added_twice")


def fused_matmul_variant(x, w, b=None, *, activation: str = "none",
                         fault: str) -> torch.Tensor:
    """act(x @ w + b) in float32, one cast to x's dtype, with ``fault``
    (one of :data:`FAULTS`): the last K slab left out of the product, or
    the first K slab added to it a second time."""
    assert fault in FAULTS, fault
    xf, wf = x.float(), w.float()
    k = wf.shape[0]
    if fault == "last_slab_dropped":
        keep = (k - 1) // SLAB * SLAB
        y = torch.matmul(xf[..., :keep], wf[:keep])
    else:
        y = torch.matmul(xf, wf) + torch.matmul(xf[..., :SLAB], wf[:SLAB])
    if b is not None:
        y = y + b.float()
    return apply_fused_activation(y, activation).to(x.dtype)
