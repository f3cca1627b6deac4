"""DataSet, the iterators ``fit`` reads, and the normalizers.

Counterpart of ``deeplearning4j_tpu/datasets/dataset.py``: ``DataSet``
(features/labels and their masks, host numpy) with
``split_test_and_train`` and ``shuffle`` (``np.random.RandomState(seed)``,
so an order matches the JAX package's bit for bit), ``DataSetIterator``
(``reset``, ``set_pre_processor``), ``ListDataSetIterator`` (in batches,
optionally reshuffled each epoch from ``seed + epoch``) and
``AsyncDataSetIterator`` (a bounded prefetch thread); and the normalizers
(``api/preprocessor/*``): ``NormalizerStandardize``,
``NormalizerMinMaxScaler`` and ``ImagePreProcessingScaler``, whose
``state()`` / ``load_state`` the model zips carry and which an iterator
applies to each batch once attached by ``set_pre_processor``. Batches stay
numpy on the host; ``fit`` moves each to the device.

The JAX package normalizes uint8 image batches in a native loop
(``native_ops/pixops.py``); the port computes the same float32
arithmetic in numpy (its documented fallback): (x − mean) · (1 / std)
channel-last for the standardizer, x · scale + shift for the scalers.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, List, Optional, Sequence, Tuple

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

    def split_test_and_train(self, n_train: int
                             ) -> Tuple["DataSet", "DataSet"]:
        """(the first ``n_train`` examples, the rest)."""
        def cut(a, lo, hi):
            return None if a is None else a[lo:hi]

        n = self.num_examples()
        return (
            DataSet(self.features[:n_train], cut(self.labels, 0, n_train),
                    cut(self.features_mask, 0, n_train),
                    cut(self.labels_mask, 0, n_train)),
            DataSet(self.features[n_train:], cut(self.labels, n_train, n),
                    cut(self.features_mask, n_train, n),
                    cut(self.labels_mask, n_train, n)),
        )

    def shuffle(self, seed: Optional[int] = None) -> None:
        """Permute the examples in place by
        ``np.random.RandomState(seed).permutation``, the JAX package's
        draw."""
        idx = np.random.RandomState(seed).permutation(self.num_examples())
        self.features = self.features[idx]
        if self.labels is not None:
            self.labels = self.labels[idx]
        if self.features_mask is not None:
            self.features_mask = self.features_mask[idx]
        if self.labels_mask is not None:
            self.labels_mask = self.labels_mask[idx]

    def batch_by(self, batch_size: int) -> List["DataSet"]:
        out = []
        for i in range(0, self.num_examples(), batch_size):
            j = i + batch_size

            def cut(a):
                return None if a is None else a[i:j]

            out.append(DataSet(self.features[i:j], cut(self.labels),
                               cut(self.features_mask), cut(self.labels_mask)))
        return out

    @staticmethod
    def merge(sets: Sequence["DataSet"]) -> "DataSet":
        def cat(parts):
            if any(p is None for p in parts):
                return None
            return np.concatenate(parts, axis=0)

        return DataSet(
            np.concatenate([d.features for d in sets], axis=0),
            cat([d.labels for d in sets]),
            cat([d.features_mask for d in sets]),
            cat([d.labels_mask for d in sets]),
        )


class DataSetIterator:
    """DataSetIterator.java analog: a resettable iterable of DataSet
    batches, each passed through the attached pre-processor."""

    def __iter__(self) -> Iterator[DataSet]:
        raise NotImplementedError

    def reset(self) -> None:
        pass

    def set_pre_processor(self, pre) -> None:
        """Attach a normalizer: its ``transform`` runs on every batch."""
        self._pre = pre

    def _maybe_pre(self, ds: DataSet) -> DataSet:
        pre = getattr(self, "_pre", None)
        if pre is not None:
            pre.transform(ds)
        return ds


class ListDataSetIterator(DataSetIterator):
    """ListDataSetIterator.java: iterate a list of DataSets, or one big
    DataSet in batches. With ``shuffle``, each pass over a big DataSet
    iterates a copy shuffled from ``seed + epoch`` (``epoch`` counts the
    passes, ``_epoch``; the training supervisor realigns it on resume)."""

    def __init__(self, data, batch_size: int = 32, shuffle: bool = False,
                 seed: int = 0):
        self._data = data if isinstance(data, DataSet) else list(data)
        self.batch_size = batch_size
        self._shuffle = shuffle
        self._seed = seed
        self._epoch = 0

    def __iter__(self):
        if isinstance(self._data, DataSet):
            ds = self._data
            if self._shuffle:
                ds = DataSet(ds.features, ds.labels, ds.features_mask,
                             ds.labels_mask)
                ds.shuffle(self._seed + self._epoch)
            self._epoch += 1
            for b in ds.batch_by(self.batch_size):
                yield self._maybe_pre(b)
        else:
            for b in self._data:
                yield self._maybe_pre(b)


class AsyncDataSetIterator(DataSetIterator):
    """AsyncDataSetIterator.java: a background thread prefetches up to
    ``prefetch`` batches of ``base``. The batches come out in order; an
    exception the worker meets is raised in the consumer; a consumer that
    leaves mid-epoch waits at most a second for the (daemon) worker."""

    def __init__(self, base: DataSetIterator, prefetch: int = 2):
        self._base = base
        self._prefetch = prefetch

    @property
    def batch_size(self) -> int:
        return self._base.batch_size

    def reset(self) -> None:
        self._base.reset()

    def __iter__(self):
        q: "queue.Queue" = queue.Queue(maxsize=self._prefetch)
        done = object()

        def worker():
            try:
                for item in self._base:
                    q.put(item)
                q.put(done)
            except BaseException as e:  # handed to the consumer, raised
                q.put(e)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            # done or the exception is the worker's last put, so a normal
            # exit joins at once; a consumer that leaves mid-epoch may
            # leave the worker blocked on a full queue
            t.join(timeout=1.0)


# ---------------------------------------------------------------------------
# Normalizers (api/preprocessor/*)
# ---------------------------------------------------------------------------


def _features(data):
    return (data.features if isinstance(data, DataSet)
            else DataSet.merge(list(data)).features)


def _u8_affine(img, scale: float, shift: float) -> np.ndarray:
    """float32 img · scale + shift of a uint8 batch (``u8_normalize``)."""
    out = np.multiply(np.ascontiguousarray(img, np.uint8), np.float32(scale),
                      dtype=np.float32)
    out += np.float32(shift)
    return out


class NormalizerStandardize:
    """NormalizerStandardize.java: per-feature z-score (the trailing axis)
    from fitted statistics."""

    def __init__(self):
        self.mean = None
        self.std = None

    def fit(self, data) -> None:
        feats = _features(data)
        axes = tuple(range(feats.ndim - 1))
        self.mean = feats.mean(axis=axes)
        self.std = feats.std(axis=axes) + 1e-8

    def transform(self, ds: DataSet) -> None:
        if (getattr(ds.features, "dtype", None) == np.uint8
                and np.ndim(self.mean) == 1
                and ds.features.shape[-1] == np.shape(self.mean)[0]):
            c = ds.features.shape[-1]
            mean = np.broadcast_to(self.mean, (c,)).astype(np.float32)
            inv = (1.0 / np.maximum(np.broadcast_to(self.std, (c,)).astype(
                np.float32), 1e-8)).astype(np.float32)
            ds.features = ((ds.features.astype(np.float32) - mean)
                           * inv).astype(np.float32)
            return
        ds.features = (ds.features - self.mean) / self.std

    def revert(self, ds: DataSet) -> None:
        ds.features = ds.features * self.std + self.mean

    def state(self):
        return {"mean": self.mean, "std": self.std}

    def load_state(self, s):
        self.mean, self.std = np.asarray(s["mean"]), np.asarray(s["std"])


class NormalizerMinMaxScaler:
    """NormalizerMinMaxScaler.java: rescale features to [lo, hi] by the
    fitted global min and max."""

    def __init__(self, lo: float = 0.0, hi: float = 1.0):
        self.lo, self.hi = lo, hi
        self.fmin = None
        self.fmax = None

    def fit(self, data) -> None:
        feats = _features(data)
        flat = feats.reshape(feats.shape[0], -1)
        self.fmin = flat.min()
        self.fmax = flat.max()

    def transform(self, ds: DataSet) -> None:
        rng = max(self.fmax - self.fmin, 1e-8)
        if getattr(ds.features, "dtype", None) == np.uint8:
            scale = (self.hi - self.lo) / rng
            ds.features = _u8_affine(ds.features, scale,
                                     self.lo - self.fmin * scale)
            return
        ds.features = ((ds.features - self.fmin) / rng * (self.hi - self.lo)
                       + self.lo)

    def state(self):
        return {"fmin": self.fmin, "fmax": self.fmax, "lo": self.lo,
                "hi": self.hi}

    def load_state(self, s):
        self.fmin, self.fmax = s["fmin"], s["fmax"]
        self.lo, self.hi = s.get("lo", 0.0), s.get("hi", 1.0)


class ImagePreProcessingScaler:
    """ImagePreProcessingScaler.java: pixels [0, max_pixel] → [lo, hi]."""

    def __init__(self, lo: float = 0.0, hi: float = 1.0,
                 max_pixel: float = 255.0):
        self.lo, self.hi, self.max_pixel = lo, hi, max_pixel

    def fit(self, data) -> None:  # stateless
        pass

    def transform(self, ds: DataSet) -> None:
        if getattr(ds.features, "dtype", None) == np.uint8:
            ds.features = _u8_affine(
                ds.features, (self.hi - self.lo) / self.max_pixel, self.lo)
            return
        ds.features = (ds.features / self.max_pixel * (self.hi - self.lo)
                       + self.lo)

    def state(self):
        return {"lo": self.lo, "hi": self.hi, "max_pixel": self.max_pixel}

    def load_state(self, s):
        self.lo, self.hi, self.max_pixel = s["lo"], s["hi"], s["max_pixel"]
