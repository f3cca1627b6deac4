"""WordPiece tokenization + BERT data iterator.

A copy of ``deeplearning4j_tpu/nlp/wordpiece.py`` (pure numpy, so the
port keeps its own copy instead of importing the JAX package): the same
vocab, tokens and batches for the same corpus and seed.

Reference parity:
  * deeplearning4j-nlp: text/tokenization/tokenizer/BertWordPieceTokenizer
    (greedy longest-match-first wordpiece over a vocab file) and
    iterator/BertIterator.java (sentence → ids with [CLS]/[SEP], padding,
    masking; tasks: SEQ_CLASSIFICATION and UNSUPERVISED MLM with 15%
    masking, 80/10/10 mask/random/keep).

Host-side numpy; the device only ever sees int32 id/mask batches
(``models.bert.BertModel`` moves them).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

PAD, UNK, CLS, SEP, MASK = "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"
SPECIALS = [PAD, UNK, CLS, SEP, MASK]


def build_vocab(corpus: Iterable[str], max_size: int = 30000,
                min_count: int = 1) -> Dict[str, int]:
    """Build a word-level + char-fallback wordpiece vocab from a corpus
    (the role of the reference's pretrained vocab file, offline)."""
    from collections import Counter

    words: Counter = Counter()
    chars: Counter = Counter()
    for line in corpus:
        for w in line.lower().split():
            words[w] += 1
            for ch in w:
                chars[ch] += 1
    vocab: Dict[str, int] = {}
    for sp in SPECIALS:
        vocab[sp] = len(vocab)
    for ch, c in chars.most_common():
        if len(vocab) >= max_size:
            break
        vocab.setdefault(ch, len(vocab))
        vocab.setdefault("##" + ch, len(vocab))
    for w, c in words.most_common():
        if c < min_count or len(vocab) >= max_size:
            continue
        vocab.setdefault(w, len(vocab))
    return vocab


class BertWordPieceTokenizer:
    """Greedy longest-match-first wordpiece (reference
    BertWordPieceTokenizer / the standard BERT algorithm)."""

    def __init__(self, vocab: Dict[str, int], lower_case: bool = True,
                 max_chars_per_word: int = 100):
        self.vocab = vocab
        self.lower_case = lower_case
        self.max_chars = max_chars_per_word
        self.inv = {i: t for t, i in vocab.items()}

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        if self.lower_case:
            text = text.lower()
        for word in text.split():
            if len(word) > self.max_chars:
                out.append(UNK)
                continue
            start = 0
            pieces: List[str] = []
            bad = False
            while start < len(word):
                end = len(word)
                cur = None
                while start < end:
                    sub = word[start:end]
                    if start > 0:
                        sub = "##" + sub
                    if sub in self.vocab:
                        cur = sub
                        break
                    end -= 1
                if cur is None:
                    bad = True
                    break
                pieces.append(cur)
                start = end
            out.extend([UNK] if bad else pieces)
        return out

    def encode(self, text: str) -> List[int]:
        return [self.vocab.get(t, self.vocab[UNK]) for t in self.tokenize(text)]

    def decode(self, ids: Sequence[int]) -> str:
        toks = [self.inv.get(int(i), UNK) for i in ids]
        s = " ".join(toks).replace(" ##", "")
        return s


class BertIterator:
    """BertIterator.java analog.

    task='seq_classification': yields (token_ids, segment_ids, input_mask,
    one-hot labels). task='unsupervised' (MLM): yields (masked_ids,
    segment_ids, input_mask, mlm_labels, mlm_mask) with 15% selection,
    80/10/10 mask/random/keep — the reference's UNSUPERVISED task.
    """

    def __init__(self, tokenizer: BertWordPieceTokenizer,
                 sentences: Sequence[str],
                 labels: Optional[Sequence[int]] = None,
                 num_classes: int = 2,
                 max_len: int = 64, batch_size: int = 16,
                 task: str = "seq_classification",
                 mask_prob: float = 0.15, seed: int = 0):
        self.tok = tokenizer
        self.sentences = list(sentences)
        self.labels = None if labels is None else list(labels)
        self.num_classes = num_classes
        self.max_len = max_len
        self._bs = batch_size
        self.task = task
        self.mask_prob = mask_prob
        self.seed = seed
        self._epoch = 0

    @property
    def batch_size(self):
        return self._bs

    def _encode_one(self, text: str) -> Tuple[np.ndarray, np.ndarray]:
        v = self.tok.vocab
        ids = [v[CLS]] + self.tok.encode(text)[: self.max_len - 2] + [v[SEP]]
        mask = [1] * len(ids)
        while len(ids) < self.max_len:
            ids.append(v[PAD])
            mask.append(0)
        return np.array(ids, np.int32), np.array(mask, np.int32)

    def __iter__(self):
        rng = np.random.RandomState(self.seed + self._epoch)
        self._epoch += 1
        order = rng.permutation(len(self.sentences))
        v = self.tok.vocab
        vocab_size = len(v)
        for i in range(0, len(order), self._bs):
            idx = order[i : i + self._bs]
            ids = np.stack([self._encode_one(self.sentences[j])[0] for j in idx])
            masks = np.stack([self._encode_one(self.sentences[j])[1] for j in idx])
            seg = np.zeros_like(ids)
            if self.task == "seq_classification":
                labs = np.zeros((len(idx), self.num_classes), np.float32)
                for r, j in enumerate(idx):
                    labs[r, self.labels[j]] = 1.0
                yield {"ids": ids, "segments": seg, "mask": masks, "labels": labs}
            else:  # unsupervised MLM
                mlm_ids = ids.copy()
                mlm_labels = np.zeros_like(ids)
                mlm_mask = np.zeros(ids.shape, np.float32)
                sel = (rng.rand(*ids.shape) < self.mask_prob) & (masks > 0)
                sel &= (ids != v[CLS]) & (ids != v[SEP])
                for r in range(ids.shape[0]):
                    for c in np.where(sel[r])[0]:
                        mlm_labels[r, c] = ids[r, c]
                        mlm_mask[r, c] = 1.0
                        p = rng.rand()
                        if p < 0.8:
                            mlm_ids[r, c] = v[MASK]
                        elif p < 0.9:
                            mlm_ids[r, c] = rng.randint(len(SPECIALS), vocab_size)
                yield {"ids": mlm_ids, "segments": seg, "mask": masks,
                       "mlm_labels": mlm_labels, "mlm_mask": mlm_mask}
