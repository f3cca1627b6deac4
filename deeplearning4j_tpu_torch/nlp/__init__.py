"""NLP data of the port: WordPiece tokenization and the BERT iterator."""

from deeplearning4j_tpu_torch.nlp.wordpiece import (
    BertIterator, BertWordPieceTokenizer, build_vocab,
)

__all__ = ["BertIterator", "BertWordPieceTokenizer", "build_vocab"]
