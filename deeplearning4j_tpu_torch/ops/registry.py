"""Named-op registry with a platform-helper table.

Counterpart of ``deeplearning4j_tpu/ops/registry.py``: each op has a plain
PyTorch implementation (the generic path, and the in-package oracle) and
may carry a hand-written kernel registered under the ``"cuda"`` platform,
chosen per call behind a ``usable`` gate — libnd4j's
``PlatformHelper::isUsable`` pattern, as the JAX package has it. A gate
that returns :data:`~.tuning.CROSSOVER` passes the arguments but sends
them to the generic by a measured crossover (``ops/tuning.py``): counted
under the reason ``"crossover"``, or taken by the kernel under
``helper_mode="kernel"`` (reason ``"forced_kernel"``).

What differs from the JAX package: the platform is read from the tensor
arguments (``"cuda"`` or ``"cpu"``), not from a process-wide backend,
because a PyTorch program places each tensor itself. Resolution runs on
every call run eagerly; a CUDA-graph capture (``ops/capture.py``) keeps
the decisions taken while it was recorded, as a jit trace keeps them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import torch

from deeplearning4j_tpu_torch.environment import environment
from deeplearning4j_tpu_torch.ops.tuning import CROSSOVER

def tensor_platform(*args: Any, **kwargs: Any) -> str:
    """Device type of the first tensor argument (``"cpu"`` when none)."""
    for a in list(args) + list(kwargs.values()):
        if isinstance(a, torch.Tensor):
            return a.device.type
    return "cpu"


def _note_dispatch(op: str, impl: str, reason: str) -> None:
    """Dispatch-decision counter ``dl4j_tpu_helper_dispatch_total``: a
    kernel-vs-generic routing change shows in the metrics instead of only
    as a throughput delta. A decision taken inside a CUDA-graph capture is
    tallied by the capture and counted at each replay instead."""
    from deeplearning4j_tpu_torch import observe
    from deeplearning4j_tpu_torch.ops import capture

    if capture.tally_dispatch(op, impl, reason):
        return

    observe.metrics().counter("dl4j_tpu_helper_dispatch_total",
                              op=op, impl=impl, reason=reason).inc()


@dataclasses.dataclass
class OpDescriptor:
    """One op: generic impl + optional platform (kernel) overrides."""

    name: str
    fn: Callable[..., Any]
    doc: str = ""
    platform_impls: Dict[str, Callable[..., Any]] = dataclasses.field(
        default_factory=dict)
    platform_usable: Dict[str, Callable[..., bool]] = dataclasses.field(
        default_factory=dict)
    # the name a platform's helper is tallied under (the platform itself
    # unless the helper names its library, as the cuDNN LSTM does)
    platform_labels: Dict[str, str] = dataclasses.field(default_factory=dict)

    def resolve(self, *args: Any, **kwargs: Any) -> Callable[..., Any]:
        """Pick the implementation for these arguments."""
        if not self.platform_impls:
            return self.fn  # helper-less op: no decision to make or count
        mode = environment().helper_mode
        if mode == "generic":
            _note_dispatch(self.name, "generic", "forced_generic")
            return self.fn
        platform = tensor_platform(*args, **kwargs)
        impl = self.platform_impls.get(platform)
        if impl is None:
            if mode == "kernel":
                raise RuntimeError(
                    f"op {self.name}: helper_mode='kernel' but no kernel is "
                    f"registered for {platform!r} tensors (kernels: "
                    f"{sorted(self.platform_impls)})")
            _note_dispatch(self.name, "generic", "no_helper")
            return self.fn
        # the usable gate comes from the SAME table entry as the impl
        usable = self.platform_usable.get(platform, lambda *a, **k: True)
        verdict = usable(*args, **kwargs)
        label = self.platform_labels.get(platform, platform)
        if verdict:
            _note_dispatch(self.name, label, "usable")
            return impl
        if verdict is CROSSOVER:
            # the kernel takes these arguments; a measured crossover
            # (ops/tuning.py) prefers the generic, unless the kernel is
            # forced
            if mode == "kernel":
                _note_dispatch(self.name, label, "forced_kernel")
                return impl
            _note_dispatch(self.name, "generic", "crossover")
            return self.fn
        if mode == "kernel":
            raise RuntimeError(
                f"op {self.name}: helper_mode='kernel' but the {platform!r} "
                f"kernel's usable gate refuses these arguments")
        _note_dispatch(self.name, "generic", "not_usable")
        return self.fn

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        return self.resolve(*args, **kwargs)(*args, **kwargs)


class OpRegistry:
    """Name -> op table."""

    def __init__(self) -> None:
        self._ops: Dict[str, OpDescriptor] = {}

    def register(self, name: str, fn: Callable[..., Any],
                 doc: str = "") -> OpDescriptor:
        if name in self._ops:
            raise ValueError(f"op '{name}' already registered")
        desc = OpDescriptor(name=name, fn=fn, doc=doc or (fn.__doc__ or ""))
        self._ops[name] = desc
        return desc

    def register_platform(self, name: str, platform: str,
                          fn: Callable[..., Any],
                          usable: Optional[Callable[..., bool]] = None,
                          label: Optional[str] = None) -> None:
        desc = self._ops[name]
        desc.platform_impls[platform] = fn
        if usable is not None:
            desc.platform_usable[platform] = usable
        if label is not None:
            desc.platform_labels[platform] = label

    def get(self, name: str) -> OpDescriptor:
        try:
            return self._ops[name]
        except KeyError:
            raise KeyError(f"unknown op '{name}' — known ops: "
                           f"{sorted(self._ops)}") from None

    def __contains__(self, name: str) -> bool:
        return name in self._ops

    def names(self) -> List[str]:
        return sorted(self._ops)

    def exec(self, name: str, *args: Any, **kwargs: Any) -> Any:
        return self.get(name)(*args, **kwargs)


_REGISTRY = OpRegistry()


def registry() -> OpRegistry:
    return _REGISTRY


def op(name: str, doc: str = "") -> Callable[[Callable[..., Any]],
                                             OpDescriptor]:
    """Decorator: register a function as a named op."""

    def wrap(fn: Callable[..., Any]) -> OpDescriptor:
        return _REGISTRY.register(name, fn, doc)

    return wrap


def exec_op(name: str, *args: Any, **kwargs: Any) -> Any:
    return _REGISTRY.exec(name, *args, **kwargs)
