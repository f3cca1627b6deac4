"""Data of the port: DataSet, the list and async iterators, the
normalizers, the synthetic ImageNet-shaped batches (host numpy, as in the
JAX package) and synthetic BERT batches in BertIterator's layout."""

from deeplearning4j_tpu_torch.datasets.dataset import (
    AsyncDataSetIterator, DataSet, DataSetIterator, ImagePreProcessingScaler,
    ListDataSetIterator,
    NormalizerMinMaxScaler, NormalizerStandardize,
)
from deeplearning4j_tpu_torch.datasets.image import synthetic_image_batch
from deeplearning4j_tpu_torch.datasets.text import synthetic_bert_batch

__all__ = ["AsyncDataSetIterator", "DataSet", "DataSetIterator", "ImagePreProcessingScaler",
           "ListDataSetIterator", "NormalizerMinMaxScaler",
           "NormalizerStandardize",
           "synthetic_bert_batch", "synthetic_image_batch"]
