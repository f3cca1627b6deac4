"""The hand-written kernels as ``torch.library`` operators.

``torch.export`` traces a function with fake tensors, which have no
``data_ptr()``: a kernel reached through ``ctypes`` cannot appear in an
exported program. Each kernel on an exported path is therefore registered
as an operator in the :data:`NAMESPACE` namespace (:func:`define`), with a
fake implementation (shapes and dtypes only), a CUDA implementation that
launches the kernel (the design choice by pointer alignment, the
workspace and any weight copy made there, where real pointers exist) and
a CPU implementation that computes the plain version (what the wrappers
have always done with CPU tensors, and what lets
``torch.library.opcheck`` run on a host without a GPU). The CUDA
implementation never calls the plain version: a kernel that fails to build
or launch raises.

The operators are defined through ``torch.library.Library``, not
``torch.library.custom_op``: ``custom_op`` wraps each kernel in
``torch._disable_dynamo``, whose first call imports ``torch._dynamo`` —
some 10 s on an H100 machine, which every process would pay at its first
kernel launch (its first token, its first step).

The operators (defined beside their kernels):

* ``flash_fwd``, ``flash_dq``, ``flash_dkv`` — ``ops/cuda_attention.py``;
  ``flash_fwd``'s autograd formula runs the other two;
* ``paged_decode`` — ``ops/cuda_attention.py``;
* ``fused_matmul`` — ``ops/cuda_matmul.py``, its backward in PyTorch;
* ``fused_updater`` (out of place) and ``fused_updater_`` (in place,
  mutating the parameters and the state) — ``ops/cuda_updater.py``;
* ``bn_matmul_stats`` — ``ops/cuda_convbn.py``: z and the per-128-row
  block partial sums, whose shape (2, M/128, N) does not depend on the
  tile width; the reduction to mean and variance stays outside;
* ``fused_layer_norm`` — ``ops/cuda_layernorm.py``, with its autograd
  formula (autograd of the float32 math on the saved inputs);
* ``matmul_int8_row_quantize`` and ``matmul_int8`` — ``ops/cuda_quantized.py``
  (the int8 weight's K-major copy made inside the CUDA implementation).

Every kernel wrapper counts its launches inside the CUDA implementation,
so a restored exported program counts as the direct call does, and a
CUDA-graph replay adds what its capture moved (``ops/capture.py``).
"""

from __future__ import annotations

import hashlib
from typing import Callable, Optional, Tuple

import torch

NAMESPACE = "dl4j_tpu_torch"
OPS: Tuple[str, ...] = ("flash_fwd", "flash_dq", "flash_dkv", "paged_decode",
                        "fused_matmul", "fused_updater", "fused_updater_",
                        "bn_matmul_stats", "fused_layer_norm",
                        "matmul_int8_row_quantize", "matmul_int8")


_LIB = torch.library.Library(NAMESPACE, "DEF")


def qualname(name: str) -> str:
    return f"{NAMESPACE}::{name}"


def define(name: str, schema: str, *, cuda: Callable, cpu: Callable,
           fake: Callable, backward: Optional[Callable] = None,
           setup_context: Optional[Callable] = None) -> None:
    """Define ``dl4j_tpu_torch::<name><schema>`` with its CUDA (the
    kernel), CPU (the plain version) and fake implementations, and, with
    ``backward``, its autograd formula."""
    _LIB.define(name + schema)
    _LIB.impl(name, cuda, "CUDA")
    _LIB.impl(name, cpu, "CPU")
    torch.library.register_fake(qualname(name), fake, lib=_LIB)
    if backward is not None:
        torch.library.register_autograd(qualname(name), backward,
                                        setup_context=setup_context,
                                        lib=_LIB)


def ops():
    """``torch.ops.dl4j_tpu_torch``, every operator registered."""
    from deeplearning4j_tpu_torch.ops import (  # noqa: F401  (registers)
        cuda_attention, cuda_convbn, cuda_layernorm, cuda_matmul,
        cuda_quantized, cuda_updater)

    return getattr(torch.ops, NAMESPACE)


def schema_digest() -> str:
    """sha256 of every operator's schema: an exported program names the
    operators it calls, so a change of any schema must miss the cache."""
    ns = ops()
    h = hashlib.sha256()
    for name in OPS:
        h.update(str(getattr(ns, name).default._schema).encode())
        h.update(b"|")
    return h.hexdigest()
