"""Data of the port: DataSet, ListDataSetIterator and the synthetic
ImageNet-shaped batches (host numpy, as in the JAX package)."""

from deeplearning4j_tpu_torch.datasets.dataset import (
    DataSet, DataSetIterator, ListDataSetIterator,
)
from deeplearning4j_tpu_torch.datasets.image import synthetic_image_batch

__all__ = ["DataSet", "DataSetIterator", "ListDataSetIterator",
           "synthetic_image_batch"]
