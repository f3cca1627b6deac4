"""ParagraphVectors (doc2vec, PV-DBOW) on the Word2Vec SGNS substrate.

Counterpart of ``deeplearning4j_tpu/nlp/paragraph_vectors.py``
(ParagraphVectors.java, dbow): a document vector is trained to predict
the words of its document with negative sampling; ``infer_vector`` fits a
fresh vector for an unseen document against the frozen word output
matrix. Every draw is the JAX package's, from
``np.random.RandomState(seed)`` in its order (the document vectors, the
epoch's permutation, its negatives — one ``choice`` an epoch, which
``RandomState`` makes equal to the JAX package's one a batch); the steps
run on the model's device (``"cuda"`` unless the caller passes
``device="cpu"``), each batch's loss kept there until the epoch ends.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.environment import resolve_device
from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec, sgns_step


class LabelledDocument:
    """nlp LabelledDocument analog: tokens and a label."""

    def __init__(self, tokens: Sequence[str], label: str):
        self.tokens = list(tokens)
        self.label = label


def infer_step(v: torch.Tensor, syn1: torch.Tensor, words, negs,
               lr) -> torch.Tensor:
    """One infer-vector step (JAX ``paragraph_vectors.py:182``): the
    SGNS gradient of a document vector against the frozen ``syn1``, the
    mean over the document's words."""
    D = v.shape[0]
    u_pos = syn1[words]
    u_neg = syn1[negs].reshape(-1, D)
    g_pos = torch.sigmoid(u_pos @ v) - 1.0
    g_neg = torch.sigmoid(u_neg @ v)
    grad = (g_pos[:, None] * u_pos).sum(0) + (g_neg[:, None] * u_neg).sum(0)
    return v - lr * grad / words.shape[0]


class ParagraphVectors:
    """ParagraphVectors.java analog (PV-DBOW)."""

    def __init__(self, layer_size: int = 100, min_word_frequency: int = 1,
                 negative_samples: int = 5, learning_rate: float = 0.025,
                 epochs: int = 5, batch_size: int = 2048, seed: int = 42,
                 window_size: int = 5, *, device=None):
        self.layer_size = layer_size
        self.min_count = min_word_frequency
        self.negative = negative_samples
        self.lr = learning_rate
        self.epochs = epochs
        self.batch_size = batch_size
        self.seed = seed
        self.window = window_size
        self.device = resolve_device(device)
        self.labels: Dict[str, int] = {}
        self.inv_labels: List[str] = []
        self._w2v = Word2Vec(layer_size=layer_size,
                             min_word_frequency=min_word_frequency,
                             negative_samples=negative_samples, seed=seed,
                             window_size=window_size, device=self.device)
        self.doc_vectors: Optional[np.ndarray] = None
        self.syn1: Optional[torch.Tensor] = None  # word output matrix
        self._neg_table: Optional[np.ndarray] = None

    # ----------------------------------------------------------------- fit
    def _mine(self, docs: List[LabelledDocument]
              ) -> Tuple[np.ndarray, np.ndarray]:
        vocab = self._w2v.vocab
        d_idx, w_idx = [], []
        for doc in docs:
            di = self.labels[doc.label]
            for w in doc.tokens:
                i = vocab.get(w.lower())
                if i is not None:
                    d_idx.append(di)
                    w_idx.append(i)
        return np.asarray(d_idx, np.int64), np.asarray(w_idx, np.int64)

    def fit(self, docs: Iterable[LabelledDocument]) -> List[float]:
        """Train ``epochs`` passes; returns each epoch's mean batch loss
        (the tail of fewer than ``batch_size`` pairs is dropped, as in
        the JAX package)."""
        docs = list(docs)
        self.labels = {}
        self.inv_labels = []
        for d in docs:
            if d.label not in self.labels:
                self.labels[d.label] = len(self.labels)
                self.inv_labels.append(d.label)
        self._w2v.build_vocab([d.tokens for d in docs])
        rng = np.random.RandomState(self.seed)
        V, D, ND = self._w2v.vocab_size(), self.layer_size, len(self.labels)
        table = self._w2v.counts ** 0.75
        self._neg_table = (table / table.sum()).astype(np.float64)
        dev = self.device
        docv = torch.from_numpy(
            ((rng.rand(ND, D) - 0.5) / D).astype(np.float32)).to(dev)
        syn1 = torch.zeros((V, D), dtype=torch.float32, device=dev)
        d_idx, w_idx = self._mine(docs)
        d_dev = torch.from_numpy(d_idx).to(dev)
        w_dev = torch.from_numpy(w_idx).to(dev)
        n = len(d_idx)
        bs = min(self.batch_size, max(n, 1))
        starts = list(range(0, n - bs + 1, bs))
        lr = torch.tensor(self.lr, dtype=torch.float32, device=dev)
        losses: List[float] = []
        for _ in range(self.epochs):
            order = rng.permutation(n)
            negs = rng.choice(V, size=(len(starts) * bs, self.negative),
                              p=self._neg_table) if starts else None
            sel = torch.from_numpy(order[:len(starts) * bs]).to(dev)
            n_dev = (None if negs is None else
                     torch.from_numpy(negs.astype(np.int64)).to(dev))
            ep = [sgns_step(docv, syn1, d_dev[sel[s0:s0 + bs]],
                            w_dev[sel[s0:s0 + bs]], n_dev[s0:s0 + bs], lr)
                  for s0 in starts]
            losses.append(float(torch.stack(ep).mean()) if ep
                          else float("nan"))
        self.doc_vectors = docv.cpu().numpy()
        self.syn1 = syn1
        return losses

    # ----------------------------------------------------------- inference
    def infer_vector(self, tokens: Sequence[str], steps: int = 25,
                     lr: float = 0.05, seed: int = 0) -> np.ndarray:
        """inferVector analog: fit a fresh document vector against the
        frozen word output matrix, ``steps`` full-document steps."""
        rng = np.random.RandomState(seed)
        ids = np.asarray([self._w2v.vocab[w.lower()] for w in tokens
                          if w.lower() in self._w2v.vocab], np.int64)
        D = self.layer_size
        if ids.size == 0:
            return np.zeros((D,), np.float32)
        dev = self.device
        v = torch.from_numpy(((rng.rand(D) - 0.5) / D).astype(
            np.float32)).to(dev)
        V = self.syn1.shape[0]
        negs = rng.choice(V, size=(steps, len(ids), self.negative),
                          p=self._neg_table)
        words = torch.from_numpy(ids).to(dev)
        negs = torch.from_numpy(negs.astype(np.int64)).to(dev)
        lr_t = torch.tensor(lr, dtype=torch.float32, device=dev)
        for i in range(steps):
            v = infer_step(v, self.syn1, words, negs[i], lr_t)
        return v.cpu().numpy()

    # ------------------------------------------------------------- lookups
    def get_doc_vector(self, label: str) -> Optional[np.ndarray]:
        i = self.labels.get(label)
        return None if i is None else self.doc_vectors[i]

    def similarity(self, a: str, b: str) -> float:
        va, vb = self.get_doc_vector(a), self.get_doc_vector(b)
        if va is None or vb is None:
            return float("nan")
        return float(va @ vb / (np.linalg.norm(va) * np.linalg.norm(vb)
                                + 1e-12))

    def nearest_labels(self, tokens: Sequence[str], n: int = 5) -> List[str]:
        """docsNearest-style lookup for an unseen document."""
        v = self.infer_vector(tokens)
        W = self.doc_vectors / (np.linalg.norm(self.doc_vectors, axis=1,
                                               keepdims=True) + 1e-12)
        sims = W @ (v / (np.linalg.norm(v) + 1e-12))
        return [self.inv_labels[i] for i in np.argsort(-sims)[:n]]
