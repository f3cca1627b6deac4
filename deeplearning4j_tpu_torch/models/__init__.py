"""Models of the port."""

from deeplearning4j_tpu_torch.models.gpt import (
    GptConfig, GptModel, gpt_decode_step, gpt_prefill, params_from_numpy,
    reference_generate, restore_gpt, save_gpt,
)

__all__ = [
    "GptConfig", "GptModel", "gpt_decode_step", "gpt_prefill",
    "params_from_numpy", "reference_generate", "restore_gpt", "save_gpt",
]
