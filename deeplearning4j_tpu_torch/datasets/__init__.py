"""Data of the port: DataSet, the list and async iterators, the
normalizers, the dataset fetchers (MNIST, CIFAR-10, EMNIST: local files
or their deterministic synthetic stand-ins), the image transforms and
file reader, the synthetic ImageNet-shaped batches (host numpy, as in the
JAX package) and synthetic BERT batches in BertIterator's layout."""

from deeplearning4j_tpu_torch.datasets.dataset import (
    AsyncDataSetIterator, DataSet, DataSetIterator, ImagePreProcessingScaler,
    ListDataSetIterator,
    NormalizerMinMaxScaler, NormalizerStandardize,
)
from deeplearning4j_tpu_torch.datasets.image import (
    ColorJitterTransform, FlipImageTransform, ImageRecordReader,
    PipelineImageTransform, RandomCropTransform, RotateImageTransform,
    SyntheticImageNetIterator, synthetic_image_batch,
)
from deeplearning4j_tpu_torch.datasets.mnist import MnistDataSetIterator
from deeplearning4j_tpu_torch.datasets.cifar import (
    EMNIST_SETS, Cifar10DataSetIterator, EmnistDataSetIterator,
    synthetic_images,
)
from deeplearning4j_tpu_torch.datasets.text import synthetic_bert_batch

__all__ = ["AsyncDataSetIterator", "DataSet", "DataSetIterator", "ImagePreProcessingScaler",
           "ListDataSetIterator", "NormalizerMinMaxScaler",
           "NormalizerStandardize",
           "ColorJitterTransform", "FlipImageTransform", "ImageRecordReader",
           "PipelineImageTransform", "RandomCropTransform",
           "RotateImageTransform", "SyntheticImageNetIterator",
           "MnistDataSetIterator", "EMNIST_SETS", "Cifar10DataSetIterator",
           "EmnistDataSetIterator", "synthetic_images",
           "synthetic_bert_batch", "synthetic_image_batch"]
