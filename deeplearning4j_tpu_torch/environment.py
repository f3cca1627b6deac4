"""Process-level configuration of the PyTorch port.

Counterpart of ``deeplearning4j_tpu/environment.py``. The port keeps only
what its ported paths read:

* :class:`Environment` ``.helper_mode`` — platform-helper selection for the
  op registry: ``"auto"`` (hand-written CUDA kernel where one is registered
  and usable, plain PyTorch elsewhere), ``"generic"`` (always the plain
  PyTorch op) or ``"kernel"`` (the kernel or an error). These are the
  counterparts of the JAX package's ``auto`` / ``xla`` / ``pallas``. Set it
  by assigning the attribute of :func:`environment`.
* :data:`DEFAULT_DEVICE` — where entry points (``GptModel``,
  ``GenerativeEngine``, ``restore_gpt``, ``init_gpt_params``,
  ``ComputationGraph``, ``ResNet50``) put their tensors when the caller
  names no device: ``"cuda"``. :func:`resolve_device` refuses it on a host
  without a GPU instead of quietly running on the CPU; the CPU is used
  only when the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

HELPER_MODES = ("auto", "generic", "kernel")
DEFAULT_DEVICE = "cuda"


@dataclasses.dataclass
class Environment:
    """Global runtime flags; access through :func:`environment`."""

    helper_mode: str = "auto"

    def __post_init__(self):
        if self.helper_mode not in HELPER_MODES:
            raise ValueError(f"helper_mode must be one of {HELPER_MODES}, "
                             f"got {self.helper_mode!r}")


_INSTANCE: Optional[Environment] = None


def environment() -> Environment:
    """The process-wide Environment singleton."""
    global _INSTANCE
    if _INSTANCE is None:
        _INSTANCE = Environment()
    return _INSTANCE


def resolve_device(device: Union[str, torch.device, None] = None
                   ) -> torch.device:
    """The device an entry point runs on: ``device`` or
    :data:`DEFAULT_DEVICE`. A CUDA device on a host without one raises —
    the port never falls back to the CPU unless the caller asks for it."""
    dev = torch.device(device if device is not None else DEFAULT_DEVICE)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but torch.cuda.is_available()"
                f" is False; pass device='cpu' to run on the host")
        if dev.index is None:  # "cuda" names the current card
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
