"""Generative serving of the port (docs: ``deeplearning4j_tpu/serving``).

Paged KV cache, continuous-batching slot scheduler, sampler and the
``GenerativeEngine`` that drives the GPT prefill/decode split through the
port's CUDA kernels.
"""

from deeplearning4j_tpu_torch.serving.cache import PagedKVCache
from deeplearning4j_tpu_torch.serving.engine import GenerativeEngine
from deeplearning4j_tpu_torch.serving.sampling import sample_tokens
from deeplearning4j_tpu_torch.serving.scheduler import (
    FINISH_REASONS, GenerationRequest, GenerationResult, SlotScheduler,
    count_terminal,
)

__all__ = [
    "PagedKVCache", "GenerativeEngine", "sample_tokens", "FINISH_REASONS",
    "GenerationRequest", "GenerationResult", "SlotScheduler",
    "count_terminal",
]
