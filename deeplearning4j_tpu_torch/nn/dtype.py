"""Dtype policy — mixed precision with float32 master weights.

Counterpart of ``deeplearning4j_tpu/nn/dtype.py``. Policies
(``ComputationGraphConfiguration.dtype``):

* ``"float32"`` / ``"float64"`` — everything in one dtype (reference
  semantics: DL4J's FLOAT means float32 math);
* ``"bfloat16"`` / ``"float16"`` — parameters stored in the low dtype;
  a layer op promotes its operands as jnp does (:func:`promote`:
  float32 input × bfloat16 weights computes in float32), so float32
  inputs give float32 activations and outputs, as in the JAX package;
* ``"mixed"`` (alias ``"mixed_bfloat16"``) — float32 parameters, updater
  state and loss, bfloat16 layer compute.

Casting happens at one chokepoint per network (the top of ``_forward``),
so gradients flow through the cast back to the float32 masters.

:func:`precision_scope` is the counterpart of the JAX package's matmul
precision scope: under the float32 policy it turns TF32 off for cuBLAS
and cuDNN (cuDNN runs float32 convolutions in TF32 by default) and
restores both switches on exit.
"""

from __future__ import annotations

import contextlib
from typing import Any, Iterator

import torch

_MIXED = ("mixed", "mixed_bfloat16")
_LOW = ("bfloat16", "float16")
_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "bfloat16": torch.bfloat16, "float16": torch.float16}


@contextlib.contextmanager
def precision_scope(policy: str) -> Iterator[None]:
    """Full float32 matmuls and convolutions under the float32 policy."""
    if policy != "float32":
        yield
        return
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def param_dtype(policy: str) -> torch.dtype:
    """Storage dtype of parameters and updater state under the policy."""
    if policy in _MIXED:
        return torch.float32
    try:
        return _DTYPES[policy]
    except KeyError:
        raise ValueError(f"unknown dtype policy {policy!r}; known: "
                         f"{sorted(_DTYPES) + list(_MIXED)}") from None


def compute_dtype(policy: str) -> torch.dtype:
    """Dtype that layer compute runs in under the policy."""
    if policy in _MIXED:
        return torch.bfloat16
    return param_dtype(policy)


def needs_cast(policy: str) -> bool:
    return policy in _MIXED


def promote(*xs):
    """``xs`` with every floating tensor in their common dtype, as jnp
    promotes the operands of one op (``torch.promote_types``: float32 ×
    bfloat16 → float32, bfloat16 × float16 → float32). None, integer
    tensors and non-tensors pass through; a tensor already in the dtype
    is returned as it is."""
    dt = None
    for x in xs:
        if isinstance(x, torch.Tensor) and x.is_floating_point():
            dt = x.dtype if dt is None else torch.promote_types(dt, x.dtype)
    return tuple(x.to(dt) if isinstance(x, torch.Tensor)
                 and x.is_floating_point() else x for x in xs)


def cast_floats(tree: Any, dtype: torch.dtype) -> Any:
    """Cast every floating tensor of a dict/list tree to ``dtype``;
    integer and bool tensors and non-tensors are untouched."""
    if isinstance(tree, dict):
        return {k: cast_floats(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_floats(v, dtype) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.to(dtype)
    return tree


def host_array(t: torch.Tensor):
    """A network output as numpy: floating tensors as float32 (numpy has
    no bfloat16), integer ones in their own dtype, as the JAX package
    returns them."""
    return (t.float() if t.is_floating_point() else t).cpu().numpy()
