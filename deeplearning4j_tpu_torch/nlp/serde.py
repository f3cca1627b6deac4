"""WordVectorSerializer: interchange formats for word vectors.

Counterpart of ``deeplearning4j_tpu/nlp/serde.py``
(WordVectorSerializer.java), host numpy, copied: the files it writes are
byte for byte the JAX writer's.

* :func:`write_word2vec_binary` / :func:`read_word2vec_binary`: the Google
  C binary format, a "<vocab> <dim>\\n" header, then per word
  "word<space>" and dim little-endian float32 values and a newline
  (tolerated on read).
* :func:`write_word2vec_text` / :func:`read_word2vec_text`: a header line,
  then "word v1 v2 ..." rows (a headerless GloVe-style file reads too).
* :func:`load_static_model`: either format as a read-only
  :class:`StaticWordVectors` (``word2vec``, ``similarity``,
  ``words_nearest``).

A model's vectors come from its ``syn0`` (Word2Vec) or ``W`` (GloVe),
read back from the device, or from a (words, matrix) pair.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch


def _vectors_of(model) -> Tuple[List[str], np.ndarray]:
    """Accept a Word2Vec (syn0), GloVe (W), ParagraphVectors (word side),
    or a plain (words, matrix) pair."""
    if isinstance(model, tuple):
        words, mat = model
        return list(words), np.asarray(mat, np.float32)
    words = list(model.inv_vocab)
    for attr in ("syn0", "W"):
        mat = getattr(model, attr, None)
        if isinstance(mat, torch.Tensor):
            mat = mat.detach().float().cpu().numpy()
        if mat is not None:
            return words, np.asarray(mat, np.float32)
    raise TypeError(
        f"{type(model).__name__} carries no exportable word vectors "
        f"(expected .syn0 or .W, or pass (words, matrix))")


def write_word2vec_binary(model, path: str) -> None:
    """WordVectorSerializer.writeWord2VecModel (binary) analog."""
    words, mat = _vectors_of(model)
    with open(path, "wb") as f:
        f.write(f"{len(words)} {mat.shape[1]}\n".encode("utf-8"))
        for w, row in zip(words, mat):
            f.write(w.encode("utf-8") + b" ")
            f.write(np.ascontiguousarray(row, "<f4").tobytes())
            f.write(b"\n")


def read_word2vec_binary(path: str) -> Tuple[List[str], np.ndarray]:
    """readWord2VecModel (binary) analog — whole-buffer scan (a 3M-word
    GoogleNews file parses in seconds, not the minutes a byte-at-a-time
    loop would take); tolerant of the optional newline between rows that
    the original C tool emits."""
    with open(path, "rb") as f:
        data = f.read()
    nl = data.find(b"\n")
    if nl < 0:
        raise ValueError("truncated word2vec binary header")
    vocab, dim = (int(x) for x in data[:nl].split())
    words: List[str] = []
    mat = np.empty((vocab, dim), np.float32)
    pos = nl + 1
    row_bytes = 4 * dim
    for i in range(vocab):
        while pos < len(data) and data[pos:pos + 1] in (b"\n", b"\r"):
            pos += 1  # inter-row newline variants
        sp = data.find(b" ", pos)
        if sp < 0 or sp + 1 + row_bytes > len(data):
            raise ValueError(f"truncated at word {i}")
        words.append(data[pos:sp].decode("utf-8"))
        mat[i] = np.frombuffer(data, "<f4", count=dim, offset=sp + 1)
        pos = sp + 1 + row_bytes
    return words, mat


def write_word2vec_text(model, path: str) -> None:
    """writeWordVectors (text) analog."""
    words, mat = _vectors_of(model)
    with open(path, "w", encoding="utf-8") as f:
        f.write(f"{len(words)} {mat.shape[1]}\n")
        for w, row in zip(words, mat):
            f.write(w + " " + " ".join(repr(float(v)) for v in row) + "\n")


def read_word2vec_text(path: str) -> Tuple[List[str], np.ndarray]:
    with open(path, encoding="utf-8") as f:
        first = f.readline().split()
        words: List[str] = []
        rows: List[np.ndarray] = []
        if len(first) == 2 and all(t.isdigit() for t in first):
            vocab, dim = int(first[0]), int(first[1])
        else:  # headerless glove-style text is accepted too
            vocab, dim = -1, len(first) - 1
            words.append(first[0])
            rows.append(np.asarray([float(v) for v in first[1:]], np.float32))
        for ln in f:
            parts = ln.rstrip("\n").split(" ")
            if len(parts) < 2:
                continue
            words.append(parts[0])
            rows.append(np.asarray([float(v) for v in parts[1:]], np.float32))
    mat = np.stack(rows) if rows else np.zeros((0, max(dim, 0)), np.float32)
    if vocab >= 0 and len(words) != vocab:
        raise ValueError(f"header declared {vocab} words, file has {len(words)}")
    return words, mat


class StaticWordVectors:
    """loadStaticModel analog: read-only lookup over loaded vectors."""

    def __init__(self, words: Sequence[str], matrix: np.ndarray):
        self.inv_vocab = list(words)
        self.vocab: Dict[str, int] = {w: i for i, w in enumerate(self.inv_vocab)}
        self.syn0 = np.asarray(matrix, np.float32)
        self._norms = np.linalg.norm(self.syn0, axis=1) + 1e-12

    def has_word(self, word: str) -> bool:
        return word in self.vocab

    def word2vec(self, word: str) -> np.ndarray:
        return self.syn0[self.vocab[word]]

    get_word_vector = word2vec  # reference alias

    def similarity(self, a: str, b: str) -> float:
        va, vb = self.word2vec(a), self.word2vec(b)
        return float(va @ vb / (np.linalg.norm(va) * np.linalg.norm(vb) + 1e-12))

    def words_nearest(self, word: str, n: int = 10) -> List[str]:
        v = self.word2vec(word)
        sims = self.syn0 @ v / (self._norms * (np.linalg.norm(v) + 1e-12))
        order = np.argsort(-sims)
        return [self.inv_vocab[i] for i in order
                if self.inv_vocab[i] != word][:n]


def load_static_model(path: str) -> StaticWordVectors:
    """Sniff binary vs text (the reference's loadStaticModel dispatch)."""
    with open(path, "rb") as f:
        header = f.readline()
        probe = f.read(256)
    try:
        header.decode("utf-8")
        is_text = True
        try:
            probe.decode("utf-8")
        except UnicodeDecodeError:
            is_text = False
    except UnicodeDecodeError:
        is_text = False
    words, mat = (read_word2vec_text(path) if is_text
                  else read_word2vec_binary(path))
    return StaticWordVectors(words, mat)
