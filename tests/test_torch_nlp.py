"""The embeddings of the PyTorch port against the JAX package (CPU).

Word2Vec: vocabulary, the mined pairs (with and without subsampling, the
port's vectorized mining against the JAX loop) and Huffman codes equal;
negative-sampling and hierarchical-softmax fits over 2 epochs from the
JAX package's initial vectors; ``.npz`` models both ways;
``distributed_word2vec_fit`` over a gloo group of 2 against the mean of
two JAX fits on the same shards. GloVe: the co-occurrence table equal in
its row order, the vectors after 3 epochs. ParagraphVectors: ``fit``,
``infer_vector`` and ``nearest_labels``. The word-vector files written
by either package read by the other and byte for byte equal. Each test
states its tolerance: float32 rounding of the same arithmetic in XLA and
PyTorch.
"""

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nlp import glove as jglove
from deeplearning4j_tpu.nlp import paragraph_vectors as jpv
from deeplearning4j_tpu.nlp import serde as jserde
from deeplearning4j_tpu.nlp import word2vec as jw2v
from deeplearning4j_tpu.parallel.launch import host_shard
from deeplearning4j_tpu_torch import nlp as tnlp
from deeplearning4j_tpu_torch.nlp import word2vec as tw2v
from deeplearning4j_tpu_torch.testing import corpus as C
from deeplearning4j_tpu_torch.testing.dist_group import run_group

# a fit of a few hundred batches from the same vectors
FIT = dict(rtol=1e-4, atol=1e-6)


def _corpus(n=3000, types=300, seed=1):
    return C.zipf_sentences(n, types, seed=seed)


def _jax_init(seed, V, D):
    """The JAX fit's fresh ``syn0`` (``word2vec.py:194``)."""
    key = jax.random.key(seed)
    return np.array((jax.random.uniform(key, (V, D)) - 0.5) / D)


def _pair(sents, **kw):
    j = jw2v.Word2Vec(**kw)
    t = tnlp.Word2Vec(device="cpu", **kw)
    j.build_vocab(sents)
    t.build_vocab(sents)
    return j, t


# ---------------------------------------------------------------------------
# Word2Vec
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("subsample,window", [(0.0, 5), (1e-2, 3), (1e-3, 1)])
def test_vocab_and_mined_pairs_equal_jax(subsample, window):
    """The port mines a sentence's draws in one call each and all pairs
    at once: the same pairs, and the generator left where the JAX loop
    leaves it (the next draw equal), over two epochs."""
    sents = _corpus() + [[], ["w0"], ["unseen"] * 3]
    j, t = _pair(sents, subsample=subsample, window_size=window,
                 min_word_frequency=2)
    assert t.inv_vocab == j.inv_vocab and t.vocab == j.vocab
    np.testing.assert_array_equal(t.counts, j.counts)
    rj, rt = np.random.RandomState(3), np.random.RandomState(3)
    for _ in range(2):
        cj, xj = j._pairs(sents, rj)
        ct, xt = t._pairs(sents, rt)
        assert len(cj) > 1000
        np.testing.assert_array_equal(ct, cj)
        np.testing.assert_array_equal(xt, xj)
        assert ct.dtype == cj.dtype == np.int32
    assert rt.rand() == rj.rand()


def test_epoch_negatives_in_one_draw_equal_the_per_batch_draws():
    """One ``choice`` over the batches that train (the tail of 1 pair is
    skipped, drawing nothing) leaves the same values and generator as
    the JAX package's draw a batch."""
    p = np.random.RandomState(0).rand(40)
    p /= p.sum()
    n, bs = 2 * 64 + 1, 64
    rj, rt = np.random.RandomState(9), np.random.RandomState(9)
    per = [rj.choice(40, size=(b - a, 5), p=p)
           for a, b in tw2v.trained_batches(n, bs)]
    assert [b - a for a, b in tw2v.trained_batches(n, bs)] == [64, 64]
    once = rt.choice(40, size=(128, 5), p=p)
    np.testing.assert_array_equal(once, np.concatenate(per))
    assert rt.rand() == rj.rand()


def test_huffman_codes_equal_jax():
    sents = _corpus()
    j, t = _pair(sents)
    for a, b in zip(t._build_huffman(), j._build_huffman()):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


@pytest.mark.parametrize("hs", [False, True])
def test_fit_two_epochs_matches_jax(hs):
    """Negative sampling (subsample 1e-2) or hierarchical softmax, 2
    epochs of batch 64 from the JAX package's initial vectors: the epoch
    losses, syn0 and syn1 (FIT)."""
    sents = _corpus()
    kw = dict(layer_size=16, window_size=3, epochs=2, batch_size=64, seed=5,
              subsample=0.0 if hs else 1e-2, use_hierarchic_softmax=hs)
    j, t = _pair(sents, **kw)
    hj = j.fit(sents)
    t.syn0 = torch.from_numpy(_jax_init(5, t.vocab_size(), 16))
    t.syn1 = torch.zeros_like(t.syn0)
    ht = t.fit(sents)
    np.testing.assert_allclose(ht, hj, rtol=1e-5)
    np.testing.assert_allclose(t.syn0.numpy(), np.asarray(j.syn0), **FIT)
    np.testing.assert_allclose(t.syn1.numpy(), np.asarray(j.syn1), **FIT)
    assert len(t.batch_losses) > 100
    assert all(b.ndim == 0 for b in t.batch_losses)


def test_fresh_vectors_and_queries():
    sents = _corpus()
    t = tnlp.Word2Vec(layer_size=8, epochs=1, seed=3, device="cpu")
    t.fit(sents)
    again = tnlp.Word2Vec(layer_size=8, epochs=1, seed=3, device="cpu")
    again.build_vocab(sents)
    again._init_vectors()
    assert again.syn0.abs().max() <= 0.5 / 8
    assert t.get_word_vector("W0").shape == (8,)
    assert t.get_word_vector("nope") is None
    assert np.isnan(t.similarity("w0", "nope"))
    assert t.words_nearest("nope") == []
    near = t.words_nearest("w1", n=4)
    assert len(near) == 4 and "w1" not in near
    # the same query through the JAX code on the same vectors
    j = jw2v.Word2Vec(layer_size=8)
    j.vocab, j.inv_vocab = t.vocab, t.inv_vocab
    j.syn0 = t.syn0.numpy()
    assert near == j.words_nearest("w1", n=4)
    assert t.similarity("w1", "w2") == pytest.approx(
        j.similarity("w1", "w2"), rel=1e-6)


def test_npz_both_ways(tmp_path):
    sents = _corpus()
    j, t = _pair(sents, layer_size=8, epochs=1, seed=2)
    j.fit(sents)
    t.fit(sents)
    jp, tp = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    j.save(jp)
    got = tnlp.Word2Vec.load(jp, device="cpu")
    assert got.inv_vocab == j.inv_vocab
    np.testing.assert_array_equal(got.syn0.numpy(), np.asarray(j.syn0))
    np.testing.assert_array_equal(got.syn1.numpy(), np.asarray(j.syn1))
    np.testing.assert_array_equal(got.counts, j.counts)
    t.save(tp)
    back = jw2v.Word2Vec.load(tp)
    assert back.inv_vocab == t.inv_vocab
    np.testing.assert_array_equal(np.asarray(back.syn0), t.syn0.numpy())
    np.testing.assert_array_equal(back.get_word_vector("w3"),
                                  t.get_word_vector("w3"))
    # a loaded model continues training from its vectors
    got.epochs, got.batch_size = 1, 64
    before = got.syn0.clone()
    got.fit(sents)
    assert got.syn0.shape == before.shape
    assert not torch.equal(got.syn0, before)


def test_distributed_fit_over_two_ranks_is_the_mean_of_the_shard_fits(
        tmp_path):
    """``distributed_word2vec_fit`` over a gloo group of 2, 2 epochs: each
    epoch every rank fits its ``host_shard`` and the matrices are
    averaged — the JAX package's single-process fits on the same shards,
    averaged, from the same start (FIT); and one process is a plain
    fit."""
    sents = _corpus(2000, 200, seed=4)
    kw = dict(layer_size=8, window_size=3, batch_size=64, seed=6)
    V = len(tw2v.build_counts(sents, 1)[0])
    syn0 = _jax_init(6, V, 8)
    syn1 = np.zeros_like(syn0)
    out = run_group(str(tmp_path / "g"), 2, [
        ("w2v", "deeplearning4j_tpu_torch.testing.corpus:w2v_rank_case",
         dict(sentences=sents, syn0=syn0, syn1=syn1, kwargs=kw, epochs=2)),
        ("hs", "deeplearning4j_tpu_torch.testing.corpus:w2v_hs_refusal",
         dict(sentences=sents))])
    s0, s1 = syn0, syn1
    losses = [[], []]
    for _ in range(2):
        fits = []
        for r in range(2):
            j = jw2v.Word2Vec(epochs=1, **kw)
            j.build_vocab(sents)
            j.syn0, j.syn1 = s0, s1
            losses[r] += j.fit(host_shard(sents, r, 2))
            fits.append(j)
        s0 = np.mean([np.asarray(f.syn0) for f in fits], axis=0)
        s1 = np.mean([np.asarray(f.syn1) for f in fits], axis=0)
    for r in range(2):
        got_losses, g0, g1 = out[r]["w2v"]
        np.testing.assert_allclose(got_losses, losses[r], rtol=1e-5)
        np.testing.assert_allclose(g0, s0, **FIT)
        np.testing.assert_allclose(g1, s1, **FIT)
    np.testing.assert_array_equal(out[0]["w2v"][1], out[1]["w2v"][1])
    # without a group: a plain fit of the whole corpus
    plain = tnlp.Word2Vec(device="cpu", epochs=1, **kw)
    single = tnlp.Word2Vec(device="cpu", epochs=1, **kw)
    assert tnlp.distributed_word2vec_fit(single, sents, epochs=1) == \
        plain.fit(sents)
    assert torch.equal(single.syn0, plain.syn0)
    # hierarchical softmax is refused over a group, as in the JAX package
    assert all("negative sampling only" in o["hs"] for o in out)


def test_port_learns_the_topic_clusters():
    """The JAX package's learning test (``tests/test_nlp_rl.py``) on the
    port: within-topic similarity beats cross-topic after 5 epochs."""
    rng = np.random.RandomState(0)
    numbers = ["one", "two", "three", "four", "five"]
    animals = ["cat", "dog", "bird", "fish", "horse"]
    sents = []
    for _ in range(300):
        pool = numbers if rng.rand() < 0.5 else animals
        sents.append([pool[rng.randint(5)] for _ in range(8)])
    w = tnlp.Word2Vec(layer_size=32, epochs=5, learning_rate=0.05, seed=2,
                      negative_samples=5, device="cpu")
    hist = w.fit(sents)
    assert hist[-1] < hist[0]
    assert w.similarity("cat", "dog") > w.similarity("cat", "two")
    hs = tnlp.Word2Vec(layer_size=16, window_size=3, epochs=8, seed=2,
                       learning_rate=0.05, use_hierarchic_softmax=True,
                       device="cpu")
    losses = hs.fit(sents)
    assert losses[-1] < losses[0]


# ---------------------------------------------------------------------------
# GloVe
# ---------------------------------------------------------------------------


def test_glove_table_order_and_three_epochs_match_jax():
    """The co-occurrence arrays equal in their (insertion) order and
    values, and W after 3 epochs of batch 512 (FIT), the epoch losses
    to 1e-5."""
    sents = _corpus(4000, 300, seed=2)
    kw = dict(layer_size=16, window_size=4, epochs=3, batch_size=512,
              seed=3, learning_rate=0.05)
    j = jglove.GloVe(**kw)
    t = tnlp.GloVe(device="cpu", **kw)
    j.build_vocab(sents)
    t.build_vocab(sents)
    assert t.inv_vocab == j.inv_vocab
    for a, b in zip(t._cooccurrences(sents), j._cooccurrences(sents)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    lj = j.fit(sents)
    lt = t.fit(sents)
    np.testing.assert_allclose(lt, lj, rtol=1e-5)
    np.testing.assert_allclose(t.W, j.W, **FIT)
    assert len(t.batch_losses) > 10
    assert t.words_nearest("w1", 3) == j.words_nearest("w1", 3)
    assert t.similarity("w1", "w2") == pytest.approx(j.similarity("w1",
                                                                  "w2"),
                                                     rel=1e-4)


def test_glove_asymmetric_and_empty():
    sents = [["a", "b", "c"], ["c", "a"]]
    j = jglove.GloVe(window_size=2, symmetric=False, layer_size=4, epochs=2)
    t = tnlp.GloVe(window_size=2, symmetric=False, layer_size=4, epochs=2,
                   device="cpu")
    j.build_vocab(sents)
    t.build_vocab(sents)
    for a, b in zip(t._cooccurrences(sents), j._cooccurrences(sents)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(t.fit(sents), j.fit(sents), rtol=1e-5)
    np.testing.assert_allclose(t.W, j.W, **FIT)
    empty = tnlp.GloVe(layer_size=4, device="cpu")
    assert empty.fit([["x"], ["y"]]) == []
    assert empty.W.shape == (2, 4) and not empty.W.any()


# ---------------------------------------------------------------------------
# ParagraphVectors
# ---------------------------------------------------------------------------


def _docs(pkg_doc, n=60):
    docs = C.labelled_documents(n, 30, 200, n_topics=4, seed=3)
    return [pkg_doc(d.tokens, d.label) for d in docs]


def test_paragraph_vectors_fit_and_infer_match_jax():
    """PV-DBOW, 3 epochs of batch 128 (the tail dropped as in JAX): the
    epoch losses, the document vectors and syn1 (FIT), ``infer_vector``
    (25 steps, seed 4) and ``nearest_labels``."""
    kw = dict(layer_size=16, epochs=3, batch_size=128, seed=5,
              learning_rate=0.05)
    j = jpv.ParagraphVectors(**kw)
    t = tnlp.ParagraphVectors(device="cpu", **kw)
    lj = j.fit(_docs(jpv.LabelledDocument))
    lt = t.fit(_docs(tnlp.LabelledDocument))
    assert t.inv_labels == j.inv_labels
    np.testing.assert_allclose(lt, lj, rtol=1e-5)
    np.testing.assert_allclose(t.doc_vectors, j.doc_vectors, **FIT)
    np.testing.assert_allclose(t.syn1.numpy(), np.asarray(j.syn1), **FIT)
    unseen = C.labelled_documents(2, 30, 200, n_topics=4, seed=99)
    for d in unseen:
        np.testing.assert_allclose(
            t.infer_vector(d.tokens, seed=4),
            j.infer_vector(d.tokens, seed=4), **FIT)
        assert t.nearest_labels(d.tokens, 3) == j.nearest_labels(d.tokens,
                                                                 3)
    np.testing.assert_array_equal(t.infer_vector(["nope"]), np.zeros(16))
    assert t.get_doc_vector("doc_3").shape == (16,)
    assert t.get_doc_vector("nope") is None
    assert t.similarity("doc_1", "doc_2") == pytest.approx(
        j.similarity("doc_1", "doc_2"), rel=1e-3)


def test_paragraph_vectors_learn_the_topics():
    """The JAX package's learning test on the port."""
    LD = tnlp.LabelledDocument
    cats = "the cat sat on the mat and the cat purred".split()
    dogs = "the dog ran in the park and the dog barked".split()
    docs = [LD(cats, "cats"), LD(dogs, "dogs"),
            LD(cats + ["feline"], "cats2"), LD(dogs + ["canine"], "dogs2")]
    pv = tnlp.ParagraphVectors(layer_size=16, epochs=60, batch_size=16,
                               learning_rate=0.05, seed=3, device="cpu")
    losses = pv.fit(docs)
    assert losses[-1] < losses[0]
    assert pv.similarity("cats", "cats2") > pv.similarity("cats", "dogs")
    near = pv.nearest_labels("the cat sat and purred".split(), n=2)
    assert "cats" in near or "cats2" in near


# ---------------------------------------------------------------------------
# serde
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fmt", ["binary", "text"])
def test_word_vector_files_both_ways_byte_for_byte(fmt, tmp_path):
    sents = _corpus(1500, 100)
    t = tnlp.Word2Vec(layer_size=6, epochs=1, seed=1, device="cpu")
    t.fit(sents)
    j = jw2v.Word2Vec(layer_size=6)
    j.vocab, j.inv_vocab, j.syn0 = t.vocab, t.inv_vocab, t.syn0.numpy()
    write_t = getattr(tnlp, f"write_word2vec_{fmt}")
    write_j = getattr(jserde, f"write_word2vec_{fmt}")
    read_t = getattr(tnlp, f"read_word2vec_{fmt}")
    read_j = getattr(jserde, f"read_word2vec_{fmt}")
    tp, jp = str(tmp_path / "t.vec"), str(tmp_path / "j.vec")
    write_t(t, tp)
    write_j(j, jp)
    with open(tp, "rb") as a, open(jp, "rb") as b:
        assert a.read() == b.read()
    for path in (tp, jp):
        (wt, mt), (wj, mj) = read_t(path), read_j(path)
        assert wt == wj == t.inv_vocab
        np.testing.assert_array_equal(mt, mj)
        np.testing.assert_array_equal(mt, t.syn0.numpy())
    static = tnlp.load_static_model(tp)
    js = jserde.load_static_model(tp)
    assert static.words_nearest("w1", 3) == js.words_nearest("w1", 3)
    assert static.has_word("w1") and not static.has_word("nope")
    np.testing.assert_array_equal(static.word2vec("w2"), js.word2vec("w2"))
    assert static.similarity("w1", "w2") == js.similarity("w1", "w2")


def test_serde_takes_glove_and_pairs_and_refuses_others(tmp_path):
    g = tnlp.GloVe(layer_size=4, window_size=2, epochs=1, device="cpu")
    g.fit([["a", "b", "c"], ["b", "c"]])
    p = str(tmp_path / "g.bin")
    tnlp.write_word2vec_binary(g, p)
    words, mat = jserde.read_word2vec_binary(p)
    assert words == g.inv_vocab
    np.testing.assert_array_equal(mat, g.W)
    q = str(tmp_path / "pair.txt")
    tnlp.write_word2vec_text((["x", "y"], np.eye(2)), q)
    assert jserde.read_word2vec_text(q)[0] == ["x", "y"]
    with open(str(tmp_path / "headerless.txt"), "w") as f:
        f.write("a 1.0 2.0\nb 3.0 4.0\n")
    words, mat = tnlp.read_word2vec_text(str(tmp_path / "headerless.txt"))
    assert words == ["a", "b"] and mat.shape == (2, 2)
    class NoVectors:
        inv_vocab = ["x"]

    with pytest.raises(TypeError, match="no exportable word vectors"):
        tnlp.write_word2vec_text(NoVectors(), q)
    with open(str(tmp_path / "short.bin"), "wb") as f:
        f.write(b"2 4\nab ")
    with pytest.raises(ValueError, match="truncated"):
        tnlp.read_word2vec_binary(str(tmp_path / "short.bin"))
