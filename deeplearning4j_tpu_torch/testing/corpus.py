"""Seeded synthetic text for the embedding tests and chip_smoke's
``word2vec`` / ``glove`` / ``paragraph_vectors`` phases (host numpy; no
text corpus ships with the repository).

* :func:`zipf_sentences`: sentences of word strings ``w<rank>`` whose
  ranks follow Zipf(1.0) over ``n_types`` types (p(k) ∝ 1/k), sentence
  lengths uniform in ``[min_len, max_len]``.
* :func:`labelled_documents`: ParagraphVectors' data: each document has a
  topic, and each token is, with probability ``topic_share``, its
  Zipf rank shifted into the topic's stretch of the vocabulary, so
  documents of one topic share words.
* :func:`w2v_rank_case`, :func:`w2v_hs_refusal`: one rank's part of the
  distributed Word2Vec test (``testing/dist_group`` runs them on every
  rank of a gloo group).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


def _zipf_cdf(n_types: int) -> np.ndarray:
    p = 1.0 / np.arange(1, n_types + 1)
    return np.cumsum(p / p.sum())


def _ranks(rng, cdf, n) -> np.ndarray:
    return np.minimum(np.searchsorted(cdf, rng.rand(n)), len(cdf) - 1)


def zipf_sentences(n_tokens: int, n_types: int, seed: int = 0,
                   min_len: int = 10, max_len: int = 30) -> List[List[str]]:
    """About ``n_tokens`` tokens (whole sentences) of Zipf(1.0) words."""
    rng = np.random.RandomState(seed)
    lens = []
    total = 0
    while total < n_tokens:
        n = int(rng.randint(min_len, max_len + 1))
        lens.append(n)
        total += n
    words = np.array([f"w{k}" for k in range(n_types)], dtype=object)
    flat = words[_ranks(rng, _zipf_cdf(n_types), total)].tolist()
    out, at = [], 0
    for n in lens:
        out.append(flat[at:at + n])
        at += n
    return out


def labelled_documents(n_docs: int, doc_len: int, n_types: int,
                       n_topics: int = 20, topic_share: float = 0.5,
                       seed: int = 0, label_prefix: str = "doc"):
    """``n_docs`` ``LabelledDocument`` s of ``doc_len`` tokens, labels
    ``<label_prefix>_<i>``."""
    from deeplearning4j_tpu_torch.nlp.paragraph_vectors import (
        LabelledDocument)

    rng = np.random.RandomState(seed)
    topics = rng.randint(n_topics, size=n_docs)
    ranks = _ranks(rng, _zipf_cdf(n_types), n_docs * doc_len).reshape(
        n_docs, doc_len)
    shift = rng.rand(n_docs, doc_len) < topic_share
    stretch = max(n_types // n_topics, 1)
    ranks = np.where(shift, (ranks + topics[:, None] * stretch) % n_types,
                     ranks)
    return [LabelledDocument([f"w{k}" for k in row], f"{label_prefix}_{i}")
            for i, row in enumerate(ranks)]


def w2v_rank_case(sentences, syn0, syn1, kwargs, epochs: Optional[int]):
    """``distributed_word2vec_fit`` on this rank of the process group,
    from the given ``syn0`` / ``syn1``, on the CPU: (losses, syn0, syn1)
    as numpy."""
    from deeplearning4j_tpu_torch.nlp.word2vec import (
        Word2Vec, distributed_word2vec_fit)

    import torch

    w2v = Word2Vec(device="cpu", **kwargs)
    w2v.build_vocab(sentences)
    w2v.syn0 = torch.from_numpy(np.array(syn0))
    w2v.syn1 = torch.from_numpy(np.array(syn1))
    losses = distributed_word2vec_fit(w2v, sentences, epochs=epochs)
    return losses, w2v.syn0.numpy(), w2v.syn1.numpy()


def w2v_hs_refusal(sentences) -> str:
    """The error ``distributed_word2vec_fit`` raises for a hierarchical
    softmax model over a group of more than one process."""
    from deeplearning4j_tpu_torch.nlp.word2vec import (
        Word2Vec, distributed_word2vec_fit)

    try:
        distributed_word2vec_fit(Word2Vec(device="cpu",
                                          use_hierarchic_softmax=True),
                                 sentences)
    except NotImplementedError as e:
        return str(e)
    return ""

