"""Models of the port."""

from deeplearning4j_tpu_torch.models.gpt import (
    GptConfig, GptModel, gpt_decode_step, gpt_prefill, params_from_numpy,
    reference_generate, restore_gpt, save_gpt,
)
from deeplearning4j_tpu_torch.models.zoo import (
    ResNet50, ZooModel, graph_state_from_numpy,
)

__all__ = [
    "GptConfig", "GptModel", "gpt_decode_step", "gpt_prefill",
    "params_from_numpy", "reference_generate", "restore_gpt", "save_gpt",
    "ResNet50", "ZooModel", "graph_state_from_numpy",
]
