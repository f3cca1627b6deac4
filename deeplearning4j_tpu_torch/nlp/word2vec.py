"""Word2Vec: skip-gram with negative sampling or hierarchical softmax.

Counterpart of ``deeplearning4j_tpu/nlp/word2vec.py`` (deeplearning4j-nlp
Word2Vec: minWordFrequency, windowSize, layerSize, negativeSample,
epochs, seed, sampling, useHierarchicSoftmax; ``fit``,
``getWordVector``, ``wordsNearest``, ``similarity``):

* The vocabulary and the Huffman tree are host Python, copied.
* Pair mining draws from ``np.random.RandomState(seed)`` in the JAX
  package's order: per sentence one ``rand`` per token when
  subsampling, then one ``randint(1, window + 1)`` per kept position;
  then the epoch's ``permutation``; then the negatives. The port draws a
  sentence's ``rand`` and ``randint`` as one call each and an epoch's
  negatives as one ``choice`` over the batches that train (the tail batch
  of fewer than 2 pairs is skipped, as in the JAX package), which
  ``RandomState`` makes equal to the per-draw calls; the pairs of all
  sentences are expanded at once with numpy in the JAX loop's order
  (``tests/test_torch_nlp.py`` holds both against the JAX package).
* The steps are the JAX package's batched updates in PyTorch on the
  model's device: gathers, ``einsum``, and ``index_add_`` into
  full-size zero buffers, each row's update divided by how often the
  row occurs in the batch. An epoch's pairs and negatives go to the
  device once; each batch's loss stays there until the epoch ends.
  ``index_add_`` on the card adds a row's duplicates in an unspecified
  order, so the card agrees with the CPU to float32 rounding, not bit
  for bit.
* The initial ``syn0`` is uniform in [−0.5, 0.5)/D from a
  ``torch.Generator`` seeded with ``seed`` on the CPU (the JAX package
  draws from ``jax.random``: a model crosses between the packages by
  ``save`` / ``load``).
* :func:`distributed_word2vec_fit`: one process a rank over
  ``torch.distributed``, the corpus split by
  ``parallel.launch.host_shard``, the matrices averaged after every epoch
  (``all_reduce`` then division by the world size).
"""

from __future__ import annotations

import heapq
from collections import Counter
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.environment import resolve_device


def build_counts(sentences, min_count: int):
    """(words by falling count, counts) of the lower-cased tokens with at
    least ``min_count`` occurrences (``Counter.most_common`` order)."""
    counter = Counter()
    for s in sentences:
        counter.update(w.lower() for w in s)
    items = [(w, c) for w, c in counter.most_common() if c >= min_count]
    return [w for w, _ in items], [c for _, c in items]


def lookup_ids(sentences, vocab: Dict[str, int]) -> List[np.ndarray]:
    """Each sentence's in-vocabulary token ids, in order."""
    out = []
    for s in sentences:
        ids = [vocab.get(w.lower()) for w in s]
        out.append(np.fromiter((i for i in ids if i is not None), np.int64))
    return out


def window_pairs(ids: List[np.ndarray], spans: List[np.ndarray],
                 window: int) -> Tuple[np.ndarray, np.ndarray]:
    """(centers, contexts): for every sentence, position and offset
    −w..w (w its ``spans`` entry, 0 skipped) that stays inside the
    sentence, in that order."""
    lens = np.array([len(x) for x in ids], np.int64)
    if not lens.sum():
        return np.zeros(0, np.int32), np.zeros(0, np.int32)
    flat = np.concatenate(ids)
    w = np.concatenate(spans)
    start = np.repeat(np.cumsum(lens) - lens, lens)
    local = np.arange(len(flat)) - start
    length = np.repeat(lens, lens)
    offs = np.concatenate([np.arange(-window, 0), np.arange(1, window + 1)])
    at = local[:, None] + offs[None, :]
    valid = ((np.abs(offs)[None, :] <= w[:, None]) & (at >= 0)
             & (at < length[:, None]))
    rows, cols = np.nonzero(valid)
    centers = flat[rows]
    contexts = flat[start[rows] + at[rows, cols]]
    return centers.astype(np.int32), contexts.astype(np.int32)


def sgns_step(syn0: torch.Tensor, syn1: torch.Tensor, centers, contexts,
              negatives, lr) -> torch.Tensor:
    """Batched SGNS update in place (JAX ``word2vec.py:134``): maximize
    log σ(v·u⁺) + Σ log σ(−v·u⁻); each row's summed gradient divided by
    its count in the batch. Returns the loss, a 0-d tensor."""
    v = syn0[centers]
    u_pos = syn1[contexts]
    u_neg = syn1[negatives]
    pos = torch.sum(v * u_pos, dim=-1)
    neg = torch.einsum("bd,bkd->bk", v, u_neg)
    g_pos = torch.sigmoid(pos) - 1.0
    g_neg = torch.sigmoid(neg)
    grad_v = g_pos[:, None] * u_pos + torch.einsum("bk,bkd->bd", g_neg, u_neg)
    grad_upos = g_pos[:, None] * v
    grad_uneg = g_neg[..., None] * v[:, None, :]
    loss = -(torch.mean(F.logsigmoid(pos))
             + torch.mean(torch.sum(F.logsigmoid(-neg), dim=-1)))
    ones = torch.ones_like(pos)
    acc0 = torch.zeros_like(syn0).index_add_(0, centers, grad_v)
    cnt0 = torch.zeros(syn0.shape[0], dtype=v.dtype,
                       device=v.device).index_add_(0, centers, ones)
    syn0.sub_(lr * acc0 / torch.clamp_min(cnt0, 1.0)[:, None])
    neg_flat = negatives.reshape(-1)
    acc1 = (torch.zeros_like(syn1).index_add_(0, contexts, grad_upos)
            .index_add_(0, neg_flat, grad_uneg.reshape(-1, v.shape[-1])))
    cnt1 = (torch.zeros(syn1.shape[0], dtype=v.dtype, device=v.device)
            .index_add_(0, contexts, ones)
            .index_add_(0, neg_flat, torch.ones_like(neg).reshape(-1)))
    syn1.sub_(lr * acc1 / torch.clamp_min(cnt1, 1.0)[:, None])
    return loss


def hs_step(syn0: torch.Tensor, syn1: torch.Tensor, centers, nodes, codes,
            mask, lr) -> torch.Tensor:
    """Batched hierarchical-softmax update in place (JAX
    ``word2vec.py:104``): along each context word's Huffman path,
    L = −Σ log σ((1 − 2·code)·v·u_node). Returns the loss, a 0-d
    tensor."""
    v = syn0[centers]
    u = syn1[nodes]
    score = torch.einsum("bd,bld->bl", v, u)
    sign = 1.0 - 2.0 * codes
    g = (torch.sigmoid(score) - (1.0 - codes)) * mask
    loss = -torch.sum(F.logsigmoid(sign * score) * mask) / torch.clamp_min(
        torch.sum(mask), 1.0)
    grad_v = torch.einsum("bl,bld->bd", g, u)
    grad_u = g[..., None] * v[:, None, :]
    acc0 = torch.zeros_like(syn0).index_add_(0, centers, grad_v)
    cnt0 = torch.zeros(syn0.shape[0], dtype=v.dtype,
                       device=v.device).index_add_(
        0, centers, torch.ones(centers.shape[0], dtype=v.dtype,
                               device=v.device))
    syn0.sub_(lr * acc0 / torch.clamp_min(cnt0, 1.0)[:, None])
    flat_nodes = nodes.reshape(-1)
    acc1 = torch.zeros_like(syn1).index_add_(
        0, flat_nodes, grad_u.reshape(-1, grad_u.shape[-1]))
    cnt1 = torch.zeros(syn1.shape[0], dtype=v.dtype,
                       device=v.device).index_add_(0, flat_nodes,
                                                   mask.reshape(-1))
    syn1.sub_(lr * acc1 / torch.clamp_min(cnt1, 1.0)[:, None])
    return loss


def huffman(counts: np.ndarray):
    """Huffman coding of a vocabulary by frequency (the reference's
    useHierarchicSoftmax path, VocabWord points/codes): (paths (V, L)
    inner-node ids, codes (V, L) 0/1 bits, mask (V, L)) padded to the
    longest code."""
    V = len(counts)
    heap = [(float(c), i) for i, c in enumerate(counts)]
    heapq.heapify(heap)
    parent, bit = {}, {}
    next_id = V  # inner nodes numbered V..2V-2
    while len(heap) > 1:
        c1, n1 = heapq.heappop(heap)
        c2, n2 = heapq.heappop(heap)
        parent[n1], bit[n1] = next_id, 0
        parent[n2], bit[n2] = next_id, 1
        heapq.heappush(heap, (c1 + c2, next_id))
        next_id += 1
    root = heap[0][1] if heap else V
    paths, codes = [], []
    for w in range(V):
        p, c = [], []
        node = w
        while node != root and node in parent:
            c.append(bit[node])
            p.append(parent[node] - V)  # inner-node table index
            node = parent[node]
        paths.append(p[::-1])
        codes.append(c[::-1])
    L = max((len(p) for p in paths), default=1)
    pad_p = np.zeros((V, L), np.int32)
    pad_c = np.zeros((V, L), np.float32)
    mask = np.zeros((V, L), np.float32)
    for w in range(V):
        n = len(paths[w])
        pad_p[w, :n] = paths[w]
        pad_c[w, :n] = codes[w]
        mask[w, :n] = 1.0
    return pad_p, pad_c, mask


def trained_batches(n: int, batch_size: int) -> List[Tuple[int, int]]:
    """(start, stop) of the batches of a pass over ``n`` pairs that
    train: every batch of at least 2 pairs."""
    return [(i, min(i + batch_size, n)) for i in range(0, n, batch_size)
            if min(i + batch_size, n) - i >= 2]


class Word2Vec:
    """Skip-gram word embeddings (negative sampling, or hierarchical
    softmax with ``use_hierarchic_softmax``) on ``device`` (``"cuda"``
    unless the caller passes ``device="cpu"``)."""

    def __init__(self, layer_size: int = 100, window_size: int = 5,
                 min_word_frequency: int = 1, negative_samples: int = 5,
                 learning_rate: float = 0.025, epochs: int = 1,
                 batch_size: int = 512, seed: int = 42,
                 subsample: float = 0.0,
                 use_hierarchic_softmax: bool = False, *, device=None):
        self.layer_size = layer_size
        self.window = window_size
        self.min_count = min_word_frequency
        self.negative = negative_samples
        self.lr = learning_rate
        self.epochs = epochs
        self.batch_size = batch_size
        self.seed = seed
        self.subsample = subsample
        self.use_hierarchic_softmax = use_hierarchic_softmax
        self.device = resolve_device(device)
        self.vocab: Dict[str, int] = {}
        self.inv_vocab: List[str] = []
        self.counts: Optional[np.ndarray] = None
        self.syn0: Optional[torch.Tensor] = None  # input vectors
        self.syn1: Optional[torch.Tensor] = None  # output vectors
        self.batch_losses: List[torch.Tensor] = []  # the last epoch's

    # ---------------------------------------------------------------- vocab
    def build_vocab(self, sentences: Iterable[Sequence[str]]) -> None:
        words, counts = build_counts(sentences, self.min_count)
        self.vocab = {w: i for i, w in enumerate(words)}
        self.inv_vocab = words
        self.counts = np.array(counts, np.float64)

    def _build_huffman(self):
        return huffman(self.counts)

    # ------------------------------------------------------------------ fit
    def _pairs(self, sentences: List[List[str]],
               rng: np.random.RandomState):
        """(centers, contexts) of one epoch, drawing from ``rng`` as the
        JAX ``_pairs`` does."""
        keep_prob = None
        if self.subsample > 0:
            freq = self.counts / self.counts.sum()
            keep_prob = np.minimum(1.0, np.sqrt(self.subsample / freq)
                                   + self.subsample / freq)
        kept, spans = [], []
        for ids in lookup_ids(sentences, self.vocab):
            if keep_prob is not None:
                ids = ids[rng.rand(len(ids)) < keep_prob[ids]]
            kept.append(ids)
            spans.append(rng.randint(1, self.window + 1, size=len(ids)))
        return window_pairs(kept, spans, self.window)

    def _init_vectors(self) -> None:
        V, D = len(self.vocab), self.layer_size
        if self.syn0 is None or tuple(self.syn0.shape) != (V, D):
            # fresh only when untrained: a loaded or partly trained model
            # continues from its vectors (reference semantics)
            gen = torch.Generator().manual_seed(self.seed)
            self.syn0 = ((torch.rand((V, D), generator=gen) - 0.5) / D).to(
                self.device)
            self.syn1 = torch.zeros((V, D), device=self.device)
        self.syn0 = self.syn0.to(self.device, torch.float32)
        self.syn1 = self.syn1.to(self.device, torch.float32)

    def _lr(self, ep: int) -> torch.Tensor:
        lr = self.lr * max(0.0001, 1.0 - ep / max(self.epochs, 1))
        return torch.tensor(lr, dtype=torch.float32, device=self.device)

    def _epoch_end(self, losses: List[torch.Tensor]) -> float:
        self.batch_losses = losses
        return (float(torch.stack(losses).mean()) if losses
                else float("nan"))

    def fit(self, sentences: Iterable[Sequence[str]]) -> List[float]:
        """Train ``epochs`` passes; returns each epoch's mean batch
        loss."""
        sentences = [list(s) for s in sentences]
        if not self.vocab:
            self.build_vocab(sentences)
        self._init_vectors()
        if self.use_hierarchic_softmax:
            return self._fit_hs(sentences)
        # unigram^0.75 negative-sampling table (the reference's table)
        probs = self.counts ** 0.75
        probs = probs / probs.sum()
        rng = np.random.RandomState(self.seed)
        dev = self.device
        history = []
        for ep in range(self.epochs):
            centers, contexts = self._pairs(sentences, rng)
            order = rng.permutation(len(centers))
            batches = trained_batches(len(order), self.batch_size)
            used = sum(b - a for a, b in batches)
            negs = (rng.choice(len(probs), size=(used, self.negative),
                               p=probs) if used else
                    np.zeros((0, self.negative), np.int64))
            c_dev = torch.from_numpy(centers[order].astype(np.int64)).to(dev)
            x_dev = torch.from_numpy(contexts[order].astype(np.int64)).to(dev)
            n_dev = torch.from_numpy(negs.astype(np.int64)).to(dev)
            lr = self._lr(ep)
            losses = []
            at = 0
            for a, b in batches:
                losses.append(sgns_step(self.syn0, self.syn1, c_dev[a:b],
                                        x_dev[a:b], n_dev[at:at + b - a],
                                        lr))
                at += b - a
            history.append(self._epoch_end(losses))
        return history

    def _fit_hs(self, sentences: List[List[str]],
                max_batches: Optional[int] = None) -> List[float]:
        """Hierarchical-softmax training (useHierarchicSoftmax=true);
        ``max_batches`` stops each epoch early (a measurement's cut)."""
        V, D = len(self.vocab), self.layer_size
        dev = self.device
        paths, codes, mask = self._build_huffman()
        # syn1 here is the inner-node table (V − 1 rows), reference syn1
        self.syn1 = torch.zeros((max(V - 1, 1), D), device=dev)
        paths_d = torch.from_numpy(paths.astype(np.int64)).to(dev)
        codes_d, mask_d = (torch.from_numpy(a).to(dev) for a in (codes,
                                                                 mask))
        rng = np.random.RandomState(self.seed)
        history = []
        for ep in range(self.epochs):
            centers, contexts = self._pairs(sentences, rng)
            order = rng.permutation(len(centers))
            c_dev = torch.from_numpy(centers[order].astype(np.int64)).to(dev)
            x_dev = torch.from_numpy(contexts[order].astype(np.int64)).to(dev)
            lr = self._lr(ep)
            losses = []
            for a, b in trained_batches(len(order),
                                        self.batch_size)[:max_batches]:
                ctx = x_dev[a:b]
                losses.append(hs_step(self.syn0, self.syn1, c_dev[a:b],
                                      paths_d[ctx], codes_d[ctx],
                                      mask_d[ctx], lr))
            history.append(self._epoch_end(losses))
        return history

    # ------------------------------------------------------------- queries
    def _matrix(self) -> np.ndarray:
        return self.syn0.detach().float().cpu().numpy()

    def get_word_vector(self, word: str) -> Optional[np.ndarray]:
        i = self.vocab.get(word.lower())
        return None if i is None else self.syn0[i].detach().cpu().numpy()

    def similarity(self, a: str, b: str) -> float:
        va, vb = self.get_word_vector(a), self.get_word_vector(b)
        if va is None or vb is None:
            return float("nan")
        return float(va @ vb / (np.linalg.norm(va) * np.linalg.norm(vb)
                                + 1e-12))

    def words_nearest(self, word: str, n: int = 10) -> List[str]:
        v = self.get_word_vector(word)
        if v is None:
            return []
        mat = self._matrix()
        sims = mat @ v / (np.linalg.norm(mat, axis=1) * np.linalg.norm(v)
                          + 1e-12)
        order = np.argsort(-sims)
        out = [self.inv_vocab[i] for i in order
               if self.inv_vocab[i] != word.lower()]
        return out[:n]

    def vocab_size(self) -> int:
        return len(self.vocab)

    # --------------------------------------------------------------- serde
    def save(self, path: str) -> None:
        """The JAX package's ``.npz`` (syn0, syn1, vocab, counts)."""
        np.savez(path, syn0=self._matrix(),
                 syn1=self.syn1.detach().float().cpu().numpy(),
                 vocab=np.array(self.inv_vocab, dtype=object),
                 counts=self.counts)

    @staticmethod
    def load(path: str, *, device=None) -> "Word2Vec":
        """A model saved by either package, on ``device``."""
        data = np.load(path, allow_pickle=True)
        w = Word2Vec(layer_size=int(data["syn0"].shape[1]), device=device)
        w.inv_vocab = list(data["vocab"])
        w.vocab = {v: i for i, v in enumerate(w.inv_vocab)}
        w.counts = data["counts"]
        w.syn0 = torch.from_numpy(np.array(data["syn0"])).to(w.device)
        w.syn1 = torch.from_numpy(np.array(data["syn1"])).to(w.device)
        return w


def distributed_word2vec_fit(w2v: Word2Vec, sentences, *,
                             epochs: Optional[int] = None) -> List[float]:
    """Cluster Word2Vec, the dl4j-spark-nlp SparkWord2Vec role (JAX
    ``word2vec.py:299``): each rank of the ``torch.distributed`` group
    trains its ``host_shard`` of the sentences for one epoch, then the
    matrices are averaged over the group (``all_reduce`` of the sum, then
    division by the world size), once an epoch. The vocabulary is built
    from the whole corpus on every rank, so it is the same everywhere.
    Without a group of more than one process it is a plain ``fit``."""
    import torch.distributed as dist

    sentences = [list(s) for s in sentences]
    if not w2v.vocab:
        w2v.build_vocab(sentences)
    epochs = epochs if epochs is not None else w2v.epochs
    n = (dist.get_world_size()
         if dist.is_available() and dist.is_initialized() else 1)
    if n == 1:
        saved = w2v.epochs
        w2v.epochs = epochs
        try:
            return w2v.fit(sentences)
        finally:
            w2v.epochs = saved
    if w2v.use_hierarchic_softmax:
        # fit() re-derives the tree and zeroes syn1 on every call, which
        # would discard the averaged inner-node table each epoch
        raise NotImplementedError(
            "distributed_word2vec_fit supports negative sampling only "
            "(hierarchical softmax rebuilds syn1 per fit call)")
    from deeplearning4j_tpu_torch.parallel.launch import host_shard

    shard = host_shard(sentences)
    # every rank holds its matrices before the collectives: a rank with
    # an empty shard never calls fit()
    w2v._init_vectors()
    losses: List[float] = []
    saved = w2v.epochs
    w2v.epochs = 1
    try:
        for _ in range(epochs):
            if shard:
                losses.extend(w2v.fit(shard))
            for mat in (w2v.syn0, w2v.syn1):
                dist.all_reduce(mat)
                mat.div_(n)
    finally:
        w2v.epochs = saved
    return losses
