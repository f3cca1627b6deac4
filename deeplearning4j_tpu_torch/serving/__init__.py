"""Generative serving of the port (docs: ``deeplearning4j_tpu/serving``).

* :class:`PagedKVCache` — the refcounted paged KV cache on the card;
* :class:`SlotScheduler` — iteration-level continuous batching;
* :class:`GenerativeEngine` — the captured prefill / write-prompt / decode
  steps through the port's CUDA kernels (causal flash prefill, paged
  decode), supervised, with the radix prefix cache (``prefix_pages``:
  :class:`RadixPrefixCache`, suffix-only prefill on a hit) and speculative
  decoding (``spec_k`` + ``draft_model``: :class:`SpeculativeDecoder`,
  :func:`perturbed_draft`, one verify pass a step);
* :class:`SLOFrontend` — priority classes, token buckets, predictive shed,
  the ``ok``/``degraded``/``shedding`` ladder and the circuit breaker;
* :class:`ClusterRouter` — N engines behind prefix affinity and load,
  quarantine, and migration of retryable requests when an engine dies;
* ``serving.overload.run_overload_ramp`` and ``serving.replay``'s
  ``run_prefix_replay``, ``run_spec_replay`` and ``run_randomized_replay``
  — the harnesses.
"""

from deeplearning4j_tpu_torch.serving.cache import PagedKVCache
from deeplearning4j_tpu_torch.serving.cluster import ClusterRouter
from deeplearning4j_tpu_torch.serving.engine import GenerativeEngine
from deeplearning4j_tpu_torch.serving.frontend import (
    OVERLOAD_STATES, ClassPolicy, LadderThresholds, SLOFrontend,
    default_classes,
)
from deeplearning4j_tpu_torch.serving.prefix import (
    PrefixMatch, RadixPrefixCache,
)
from deeplearning4j_tpu_torch.serving.sampling import sample_tokens
from deeplearning4j_tpu_torch.serving.scheduler import (
    FINISH_REASONS, GenerationRequest, GenerationResult, SlotScheduler,
    count_terminal,
)
from deeplearning4j_tpu_torch.serving.speculative import (
    SpeculativeDecoder, perturbed_draft,
)

__all__ = [
    "PagedKVCache", "GenerativeEngine", "ClusterRouter", "sample_tokens",
    "GenerationRequest", "GenerationResult", "SlotScheduler",
    "FINISH_REASONS", "SLOFrontend", "ClassPolicy", "LadderThresholds",
    "OVERLOAD_STATES", "default_classes", "RadixPrefixCache",
    "PrefixMatch", "SpeculativeDecoder", "perturbed_draft",
    "count_terminal",
]
