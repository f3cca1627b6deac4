"""The data API of the PyTorch port against the JAX package (CPU).

``DataSet.shuffle`` and ``split_test_and_train``, shuffled
``ListDataSetIterator`` epochs and pre-processors attached with
``set_pre_processor`` give exactly the JAX package's arrays (both draw
from ``np.random.RandomState``); the one exception is a uint8 batch
through a scaler, which the JAX package normalizes in a native loop that
may fuse the multiply-add (1e-6, as ``test_torch_eval_listeners.py``
holds the normalizers). ``AsyncDataSetIterator`` keeps the order, hands
a worker's exception to the consumer, and lets a consumer leave
mid-epoch.
"""

import threading
import time

import numpy as np
import pytest

from deeplearning4j_tpu.datasets import dataset as jds
from deeplearning4j_tpu_torch.datasets import dataset as tds


def _data(n=10, masks=True, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 4, 3)).astype(np.float32)
    y = np.eye(5, dtype=np.float32)[rng.integers(0, 5, (n, 4))]
    fm = (rng.random((n, 4)) > 0.3).astype(np.float32) if masks else None
    lm = (rng.random((n, 4)) > 0.3).astype(np.float32) if masks else None
    return x, y, fm, lm


def _arrays(ds):
    return [ds.features, ds.labels, ds.features_mask, ds.labels_mask]


def _assert_same(a, b):
    for u, v in zip(_arrays(a), _arrays(b)):
        assert (u is None) == (v is None)
        if u is not None:
            np.testing.assert_array_equal(u, v)
            assert u.dtype == v.dtype


@pytest.mark.parametrize("seed", [None, 0, 7, 12345])
@pytest.mark.parametrize("masks", [True, False])
def test_shuffle_matches_jax(seed, masks):
    arrays = _data(masks=masks)
    t, j = tds.DataSet(*arrays), jds.DataSet(*arrays)
    if seed is None:  # unseeded draws differ: only the permutation holds
        t.shuffle()
        assert sorted(map(tuple, t.features.reshape(10, -1))) == sorted(
            map(tuple, arrays[0].reshape(10, -1)))
        return
    t.shuffle(seed)
    j.shuffle(seed)
    _assert_same(t, j)
    assert not np.array_equal(t.features, arrays[0])


@pytest.mark.parametrize("n_train", [0, 3, 10])
def test_split_test_and_train_matches_jax(n_train):
    arrays = _data()
    (ta, tb), (ja, jb) = (tds.DataSet(*arrays).split_test_and_train(n_train),
                          jds.DataSet(*arrays).split_test_and_train(n_train))
    _assert_same(ta, ja)
    _assert_same(tb, jb)
    assert ta.num_examples() == n_train and tb.num_examples() == 10 - n_train


@pytest.mark.parametrize("shuffle", [False, True])
def test_list_iterator_epochs_match_jax(shuffle):
    """Three passes of batch 4 over 10 examples: each epoch reshuffled
    from seed + epoch, exactly as the JAX iterator orders them; the
    source DataSet is left as it was."""
    arrays = _data()
    t = tds.ListDataSetIterator(tds.DataSet(*arrays), batch_size=4,
                                shuffle=shuffle, seed=3)
    j = jds.ListDataSetIterator(jds.DataSet(*arrays), batch_size=4,
                                shuffle=shuffle, seed=3)
    orders = []
    for _ in range(3):
        tb, jb = list(t), list(j)
        assert [b.num_examples() for b in tb] == [4, 4, 2]
        for a, b in zip(tb, jb):
            _assert_same(a, b)
        orders.append(np.concatenate([b.features for b in tb]))
    assert t._epoch == j._epoch == 3
    assert shuffle == (not np.array_equal(orders[0], orders[1]))
    np.testing.assert_array_equal(t._data.features, arrays[0])


def test_realigned_epoch_counter_replays_the_order():
    """The supervisor's realignment: setting ``_epoch`` replays that
    epoch's order."""
    arrays = _data()
    it = tds.ListDataSetIterator(tds.DataSet(*arrays), batch_size=4,
                                 shuffle=True, seed=9)
    first, second = list(it), list(it)
    it._epoch = 1
    for a, b in zip(list(it), second):
        _assert_same(a, b)
    it._epoch = 0
    for a, b in zip(list(it), first):
        _assert_same(a, b)


@pytest.mark.parametrize("name,kind", [
    ("NormalizerStandardize", "float32"),
    ("NormalizerMinMaxScaler", "float32"),
    ("ImagePreProcessingScaler", "float32"),
    ("ImagePreProcessingScaler", "uint8"),
    ("NormalizerStandardize", "uint8"),
])
def test_set_pre_processor_matches_jax(name, kind):
    rng = np.random.default_rng(5)
    x = (rng.integers(0, 256, (10, 4, 4, 3)).astype(np.uint8)
         if kind == "uint8"
         else rng.standard_normal((10, 4, 4, 3)).astype(np.float32))
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 10)]
    tn, jn = getattr(tds, name)(), getattr(jds, name)()
    tn.fit(tds.DataSet(x))
    jn.fit(jds.DataSet(x))
    t = tds.ListDataSetIterator(tds.DataSet(x, y), batch_size=4,
                                shuffle=True, seed=1)
    j = jds.ListDataSetIterator(jds.DataSet(x, y), batch_size=4,
                                shuffle=True, seed=1)
    t.set_pre_processor(tn)
    j.set_pre_processor(jn)
    for a, b in zip(list(t), list(j)):
        assert a.features.dtype == b.features.dtype == np.float32
        if kind == "uint8":
            np.testing.assert_allclose(a.features, b.features, rtol=1e-6,
                                       atol=1e-6)
        else:
            np.testing.assert_array_equal(a.features, b.features)
        np.testing.assert_array_equal(a.labels, b.labels)
    # the source keeps its raw values: each pass normalizes fresh batches
    np.testing.assert_array_equal(t._data.features, x)


def test_list_of_datasets_gets_the_pre_processor_and_reset():
    batches = [tds.DataSet(np.full((2, 3), i, np.float32)) for i in range(3)]
    it = tds.ListDataSetIterator(batches)
    it.set_pre_processor(tds.ImagePreProcessingScaler(max_pixel=2.0))
    it.reset()
    assert [float(b.features[0, 0]) for b in it] == [0.0, 0.5, 1.0]


def test_async_iterator_keeps_order_and_batch_size():
    arrays = _data(n=23)
    base = tds.ListDataSetIterator(tds.DataSet(*arrays), batch_size=4,
                                   shuffle=True, seed=2)
    want = list(tds.ListDataSetIterator(tds.DataSet(*arrays), batch_size=4,
                                        shuffle=True, seed=2))
    it = tds.AsyncDataSetIterator(base, prefetch=2)
    assert it.batch_size == 4
    got = list(it)
    assert len(got) == len(want) == 6
    for a, b in zip(got, want):
        _assert_same(a, b)


def test_async_iterator_raises_the_worker_exception_in_the_consumer():
    class Failing(tds.DataSetIterator):
        def __iter__(self):
            yield tds.DataSet(np.zeros((1, 2), np.float32))
            raise OSError("disk read failed")

    got = []
    with pytest.raises(OSError, match="disk read failed"):
        for ds in tds.AsyncDataSetIterator(Failing()):
            got.append(ds)
    assert len(got) == 1


def test_async_iterator_consumer_may_leave_mid_epoch():
    """A consumer that stops after one batch of a long source: closing
    the generator returns within the bounded join, the worker blocked on
    the full queue."""
    class Endless(tds.DataSetIterator):
        def __iter__(self):
            while True:
                yield tds.DataSet(np.zeros((1, 2), np.float32))

    before = threading.active_count()
    gen = iter(tds.AsyncDataSetIterator(Endless(), prefetch=1))
    next(gen)
    t0 = time.perf_counter()
    gen.close()
    assert time.perf_counter() - t0 < 5.0
    assert threading.active_count() <= before + 1  # one daemon at most
