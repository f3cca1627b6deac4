"""Synthetic BERT batches in the layout ``nlp.BertIterator`` yields.

No corpus or GLUE data ships with the repository, so the card's BERT runs
draw token ids from a numpy seed instead of tokenizing text: ``[CLS]``
first, ``[SEP]`` at each row's length, ``[PAD]`` after it (ids of the
specials as ``nlp.wordpiece.build_vocab`` numbers them), and for the MLM
task BertIterator's selection of 15% of the real, non-special positions
with 80/10/10 [MASK]/random/keep replacement.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from deeplearning4j_tpu_torch.nlp.wordpiece import (
    CLS, MASK, PAD, SEP, SPECIALS,
)

_ID = {tok: i for i, tok in enumerate(SPECIALS)}


def synthetic_bert_batch(batch: int, seq: int, vocab_size: int, *,
                         task: str = "seq_classification", seed: int = 0,
                         min_len: Optional[int] = None, num_classes: int = 2,
                         mask_prob: float = 0.15) -> Dict[str, np.ndarray]:
    """One batch: ``ids``, ``segments``, ``mask`` (int32 (batch, seq)) and
    ``labels`` (one-hot float32) for ``task="seq_classification"``, or
    ``mlm_labels`` (int32) and ``mlm_mask`` (float32) for
    ``task="unsupervised"``. Row lengths are drawn from
    ``[min_len, seq]`` (every row full when ``min_len`` is None)."""
    rng = np.random.default_rng(seed)
    lens = (np.full(batch, seq) if min_len is None
            else rng.integers(min_len, seq + 1, batch))
    ids = rng.integers(len(SPECIALS), vocab_size, (batch, seq))
    ids[:, 0] = _ID[CLS]
    ids[np.arange(batch), lens - 1] = _ID[SEP]
    mask = np.arange(seq)[None, :] < lens[:, None]
    ids = np.where(mask, ids, _ID[PAD]).astype(np.int32)
    out = {"ids": ids, "segments": np.zeros_like(ids),
           "mask": mask.astype(np.int32)}
    if task == "seq_classification":
        out["labels"] = np.eye(num_classes, dtype=np.float32)[
            rng.integers(0, num_classes, batch)]
        return out
    sel = ((rng.random(ids.shape) < mask_prob) & mask
           & (ids != _ID[CLS]) & (ids != _ID[SEP]))
    p = rng.random(ids.shape)
    masked = np.where(sel & (p < 0.8), _ID[MASK], ids)
    masked = np.where(sel & (p >= 0.8) & (p < 0.9),
                      rng.integers(len(SPECIALS), vocab_size, ids.shape),
                      masked)
    out.update(ids=masked.astype(np.int32),
               mlm_labels=np.where(sel, ids, 0).astype(np.int32),
               mlm_mask=sel.astype(np.float32))
    return out
