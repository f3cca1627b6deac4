"""DataSet and the iterators ``fit`` uses.

Counterpart of the part of ``deeplearning4j_tpu/datasets/dataset.py`` that
``ComputationGraph.fit`` reaches: ``DataSet`` (features/labels and their
masks, host numpy), ``DataSetIterator`` and ``ListDataSetIterator``.
Batches stay numpy on the host; ``fit`` moves each to the device.
"""

from __future__ import annotations

from typing import Iterator, List

import numpy as np


class DataSet:
    """features/labels (+ masks) minibatch container (DataSet.java)."""

    def __init__(self, features, labels=None, features_mask=None,
                 labels_mask=None):
        self.features = np.asarray(features)
        self.labels = None if labels is None else np.asarray(labels)
        self.features_mask = (None if features_mask is None
                              else np.asarray(features_mask))
        self.labels_mask = (None if labels_mask is None
                            else np.asarray(labels_mask))

    def num_examples(self) -> int:
        return int(self.features.shape[0])

    def batch_by(self, batch_size: int) -> List["DataSet"]:
        out = []
        for i in range(0, self.num_examples(), batch_size):
            j = i + batch_size

            def cut(a):
                return None if a is None else a[i:j]

            out.append(DataSet(self.features[i:j], cut(self.labels),
                               cut(self.features_mask), cut(self.labels_mask)))
        return out


class DataSetIterator:
    """DataSetIterator.java analog: an iterable of DataSet batches."""

    def __iter__(self) -> Iterator[DataSet]:
        raise NotImplementedError


class ListDataSetIterator(DataSetIterator):
    """ListDataSetIterator.java: iterate a list of DataSets, or one big
    DataSet in batches."""

    def __init__(self, data, batch_size: int = 32):
        self._data = data if isinstance(data, DataSet) else list(data)
        self.batch_size = batch_size

    def __iter__(self):
        if isinstance(self._data, DataSet):
            yield from self._data.batch_by(self.batch_size)
        else:
            yield from self._data
