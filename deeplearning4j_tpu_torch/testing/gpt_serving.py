"""Inputs shared by the serving parity tests: a tiny GPT's parameter tree
filled from numpy, which both packages load (the JAX package as
``jax.numpy`` arrays, the port through ``params_from_numpy``), and the
prompts the tests serve.

The weights are drawn at std 2/sqrt(hidden) with random biases and
LayerNorm affines, so greedy generation does not collapse onto the last
prompt token and token-for-token checks mean something.
"""

from __future__ import annotations

import numpy as np

from deeplearning4j_tpu_torch.models._tree import leaf_paths, rebuild
from deeplearning4j_tpu_torch.models.gpt import GptConfig, param_shapes

#: the serving tests' model: 2 layers, hidden 32, 4 heads
TINY = dict(hidden=32, layers=2, heads=4, intermediate=64)

#: an 11-token system prompt: one full page of 8 and a mid-page tail of 3
SYSTEM_PROMPT = np.arange(42, 53, dtype=np.int32)


def tiny_config(**kw) -> GptConfig:
    d = dict(TINY)
    d.update(kw)
    return GptConfig.tiny(**d)


def numpy_gpt_params(cfg: GptConfig, seed: int = 0) -> dict:
    """The JAX ``init_gpt_params`` tree's structure, filled from a numpy
    ``RandomState(seed)``."""
    r = np.random.RandomState(seed)
    std = 2.0 / np.sqrt(cfg.hidden)

    def fill(path, shape):
        name = path[-1]
        if name == "ln_gamma":
            return (1.0 + 0.1 * r.randn(*shape)).astype(np.float32)
        if name.startswith("b") or name == "ln_beta":
            return (0.1 * r.randn(*shape)).astype(np.float32)
        return (std * r.randn(*shape)).astype(np.float32)

    shapes = param_shapes(cfg)
    return rebuild(shapes, {p: fill(p, s) for p, s in leaf_paths(shapes)})


def shared_prefix_prompts(tails) -> list:
    """:data:`SYSTEM_PROMPT` followed by each tail."""
    return [np.concatenate([SYSTEM_PROMPT, np.asarray(t, np.int32)])
            for t in tails]
