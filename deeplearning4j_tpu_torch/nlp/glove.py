"""GloVe: global co-occurrence factorization embeddings.

Counterpart of ``deeplearning4j_tpu/nlp/glove.py`` (Glove.Builder:
layerSize, windowSize, minWordFrequency, xMax, alpha, learningRate,
epochs; AbstractCoOccurrences; GloveWeightLookupTable's per-parameter
AdaGrad): the weighted least squares J = Σ f(X_ij)(wᵢ·w̃ⱼ + bᵢ + b̃ⱼ −
log X_ij)².

* The co-occurrence table is built on the host as the JAX package builds
  it: a dict filled in corpus order (its insertion order is the row
  order the epochs' permutations index), each weight 1/distance summed
  as a Python float, cast to float32 at the end.
* The initial vectors and every permutation come from
  ``np.random.RandomState(seed)`` as in the JAX package.
* An epoch is a loop over its batches on the model's device
  (``"cuda"`` unless the caller passes ``device="cpu"``), the parameters
  and AdaGrad sums updated in place; each batch's gradients come from
  the parameters before any of its updates, and each AdaGrad update adds
  g² into the sum at every (duplicate) index with ``index_add_`` before
  it reads the sum back, as the JAX scan does. The batch losses stay on
  the device until the epoch ends.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch.environment import resolve_device
from deeplearning4j_tpu_torch.nlp.word2vec import build_counts


def _adagrad(p: torch.Tensor, h: torch.Tensor, g: torch.Tensor, ix,
             lr: float) -> None:
    """h[ix] += g² (every duplicate), then p[ix] −= lr·g/√h[ix]."""
    h.index_add_(0, ix, g * g)
    p.index_add_(0, ix, -lr * g / torch.sqrt(h[ix]))


def glove_batch(state, rows, cols, logx, fx, idx, lr: float) -> torch.Tensor:
    """One AdaGrad batch in place over ``state`` = (w, w̃, b, b̃ and their
    AdaGrad sums) (JAX ``glove.py:104``); returns the batch loss."""
    w, wc, b, bc, hw, hwc, hb, hbc = state
    i = rows[idx]
    j = cols[idx]
    wi, wj = w[i], wc[j]
    diff = torch.sum(wi * wj, dim=-1) + b[i] + bc[j] - logx[idx]
    fdiff = fx[idx] * diff
    loss = torch.mean(fdiff * diff)
    gw = fdiff[:, None] * wj
    gwc = fdiff[:, None] * wi
    _adagrad(w, hw, gw, i, lr)
    _adagrad(wc, hwc, gwc, j, lr)
    _adagrad(b, hb, fdiff, i, lr)
    _adagrad(bc, hbc, fdiff, j, lr)
    return loss


def init_state(V: int, D: int, rng: np.random.RandomState, device):
    """(w, w̃, b, b̃, and their AdaGrad sums at 1) on ``device``: w and w̃
    uniform in ±0.5/D from ``rng``, as the JAX package draws them."""
    scale = 0.5 / D
    w, wc = (torch.from_numpy(rng.uniform(-scale, scale, (V, D)).astype(
        np.float32)).to(device) for _ in range(2))
    return (w, wc, torch.zeros(V, device=device),
            torch.zeros(V, device=device), torch.ones((V, D), device=device),
            torch.ones((V, D), device=device), torch.ones(V, device=device),
            torch.ones(V, device=device))


def table_tensors(rows, cols, vals, x_max: float, alpha: float, device):
    """The co-occurrence table on ``device``: (rows, cols, log X, the
    weights f(X) = min((X/x_max)^α, 1))."""
    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return (put(rows.astype(np.int64)), put(cols.astype(np.int64)),
            put(np.log(vals)),
            put(np.minimum((vals / x_max) ** alpha, 1.0).astype(np.float32)))


class GloVe:
    """Glove.java analog (the same knob names, snake_cased)."""

    def __init__(self, layer_size: int = 100, window_size: int = 5,
                 min_word_frequency: int = 1, x_max: float = 100.0,
                 alpha: float = 0.75, learning_rate: float = 0.05,
                 epochs: int = 25, batch_size: int = 4096, seed: int = 42,
                 symmetric: bool = True, *, device=None):
        self.layer_size = layer_size
        self.window = window_size
        self.min_count = min_word_frequency
        self.x_max = x_max
        self.alpha = alpha
        self.lr = learning_rate
        self.epochs = epochs
        self.batch_size = batch_size
        self.seed = seed
        self.symmetric = symmetric
        self.device = resolve_device(device)
        self.vocab: Dict[str, int] = {}
        self.inv_vocab: List[str] = []
        self.W: Optional[np.ndarray] = None  # final vectors (w + w̃)
        self.batch_losses: List[torch.Tensor] = []  # the last epoch's

    # ---------------------------------------------------------------- vocab
    def build_vocab(self, sentences: Iterable[Sequence[str]]) -> None:
        self.inv_vocab = build_counts(sentences, self.min_count)[0]
        self.vocab = {w: i for i, w in enumerate(self.inv_vocab)}

    def _cooccurrences(self, sentences: List[List[str]]):
        """AbstractCoOccurrences analog: window counts weighted
        1/distance, (rows, cols, vals) in first-seen order."""
        cooc: Dict[tuple, float] = defaultdict(float)
        for s in sentences:
            ids = [self.vocab[w.lower()] for w in s
                   if w.lower() in self.vocab]
            for pos, ci in enumerate(ids):
                for off in range(1, self.window + 1):
                    j = pos + off
                    if j >= len(ids):
                        break
                    w = 1.0 / off
                    cooc[(ci, ids[j])] += w
                    if self.symmetric:
                        cooc[(ids[j], ci)] += w
        rows = np.fromiter((k[0] for k in cooc), np.int32, len(cooc))
        cols = np.fromiter((k[1] for k in cooc), np.int32, len(cooc))
        vals = np.fromiter(cooc.values(), np.float32, len(cooc))
        return rows, cols, vals

    # ------------------------------------------------------------------ fit
    def fit(self, sentences: Iterable[Sequence[str]]) -> List[float]:
        """Train ``epochs`` passes over the shuffled nonzeros (whole
        batches only); returns each epoch's mean batch loss."""
        sentences = [list(s) for s in sentences]
        if not self.vocab:
            self.build_vocab(sentences)
        rows, cols, vals = self._cooccurrences(sentences)
        return self.fit_table(rows, cols, vals)

    def fit_table(self, rows: np.ndarray, cols: np.ndarray,
                  vals: np.ndarray) -> List[float]:
        """:meth:`fit` from a built co-occurrence table."""
        V, D = len(self.vocab), self.layer_size
        dev = self.device
        rng = np.random.RandomState(self.seed)
        state = init_state(V, D, rng, dev)
        w, wc = state[0], state[1]

        n = len(vals)
        if n == 0:
            self.W = np.zeros((V, D), np.float32)
            return []  # nothing co-occurred (empty corpus / all filtered)
        rows_d, cols_d, logx, fx = table_tensors(rows, cols, vals, self.x_max,
                                                 self.alpha, dev)
        bs = min(self.batch_size, n)
        losses: List[float] = []
        for _ in range(self.epochs):
            order = rng.permutation(n)
            nb = n // bs
            batches = torch.from_numpy(order[:nb * bs].reshape(nb, bs)).to(
                dev)
            ls = [glove_batch(state, rows_d, cols_d, logx, fx, batches[k],
                              self.lr) for k in range(nb)]
            self.batch_losses = ls
            losses.append(float(torch.stack(ls).mean()))
        self.W = (w + wc).cpu().numpy()  # the published GloVe convention
        return losses

    # ------------------------------------------------------------- lookups
    def get_word_vector(self, word: str) -> Optional[np.ndarray]:
        i = self.vocab.get(word.lower())
        return None if i is None else self.W[i]

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
        W = self.W / (np.linalg.norm(self.W, axis=1, keepdims=True) + 1e-12)
        sims = W @ (v / (np.linalg.norm(v) + 1e-12))
        idx = np.argsort(-sims)
        out = [self.inv_vocab[i] for i in idx
               if self.inv_vocab[i] != word.lower()]
        return out[:n]

    def vocab_size(self) -> int:
        return len(self.vocab)
