"""deeplearning4j_tpu_torch — the PyTorch + CUDA port of deeplearning4j_tpu.

The JAX package ``deeplearning4j_tpu`` is the reference; this package is
its port to PyTorch on an NVIDIA H100, module by module, with every TPU
(Pallas) kernel on a ported path rewritten by hand for Hopper
(``csrc/``). It imports ``torch`` and never ``jax`` nor anything of the
JAX package.

Ported so far: generative serving of GPT — ``models.gpt``, the paged KV
cache, scheduler, sampler and ``serving.GenerativeEngine`` — over causal
flash prefill and paged decode (``ops.cuda_attention``); and training
through ``nn.ComputationGraph`` — ``models.ResNet50(...).init().fit`` —
over the fused updater step (``ops.cuda_updater``) and the fused
BN-apply/1×1-matmul/BN-stats kernel (``ops.cuda_convbn``); and BERT
training — ``models.BertModel(...).fit_classifier`` / ``fit_mlm`` — over
differentiable flash attention with in-kernel dropout and the dq and
dk/dv backward kernels; and imported graphs —
``imports.import_onnx(bytes)`` → ``autodiff.SameDiff`` → the graph
optimizer's fusion tier → ``sd.output`` — over flash attention and the
fused matmul + bias + activation epilogue (``ops.cuda_matmul``); and
checkpointed, supervised training and serving (``parallel``,
``faults``). Entry points run on ``"cuda"`` unless the caller passes
``device="cpu"``.
"""

from deeplearning4j_tpu_torch import observe, ops  # noqa: F401
from deeplearning4j_tpu_torch.environment import (
    Environment, environment, resolve_device,
)

__all__ = ["Environment", "environment", "resolve_device", "observe", "ops"]
