"""Models of the port."""

from deeplearning4j_tpu_torch.models.bert import (
    BertConfig, BertModel, bert_encoder, bert_opt_state_from_numpy,
    bert_params_from_numpy, classification_logits, init_bert_params,
    mlm_logits,
)
from deeplearning4j_tpu_torch.models.gpt import (
    GptConfig, GptModel, gpt_decode_step, gpt_prefill, params_from_numpy,
    reference_generate, restore_gpt, save_gpt,
)
from deeplearning4j_tpu_torch.models.zoo import (
    GPT, VGG16, VGG19, YOLO2, AlexNet, Darknet19, InceptionResNetV1, LeNet,
    ResNet50, SimpleCNN, SqueezeNet, TextGenerationLSTM, TinyYOLO, UNet,
    Xception, ZooModel, graph_state_from_numpy,
)

__all__ = [
    "BertConfig", "BertModel", "bert_encoder", "bert_opt_state_from_numpy",
    "bert_params_from_numpy", "classification_logits", "init_bert_params",
    "mlm_logits",
    "GptConfig", "GptModel", "gpt_decode_step", "gpt_prefill",
    "params_from_numpy", "reference_generate", "restore_gpt", "save_gpt",
    "GPT", "VGG16", "VGG19", "YOLO2", "AlexNet", "Darknet19",
    "InceptionResNetV1", "LeNet", "ResNet50", "SimpleCNN", "SqueezeNet",
    "TextGenerationLSTM", "TinyYOLO", "UNet", "Xception", "ZooModel",
    "graph_state_from_numpy",
]
