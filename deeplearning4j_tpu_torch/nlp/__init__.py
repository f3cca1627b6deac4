"""NLP of the port: WordPiece tokenization and the BERT iterator; the
embeddings — Word2Vec (negative sampling and hierarchical softmax, and
its distributed fit), GloVe, ParagraphVectors — and the word-vector
interchange formats (counterpart of ``deeplearning4j_tpu/nlp``)."""

from deeplearning4j_tpu_torch.nlp.wordpiece import (
    BertIterator, BertWordPieceTokenizer, build_vocab,
)
from deeplearning4j_tpu_torch.nlp.word2vec import (
    Word2Vec, distributed_word2vec_fit,
)
from deeplearning4j_tpu_torch.nlp.glove import GloVe
from deeplearning4j_tpu_torch.nlp.paragraph_vectors import (
    LabelledDocument, ParagraphVectors,
)
from deeplearning4j_tpu_torch.nlp.serde import (
    StaticWordVectors, load_static_model, read_word2vec_binary,
    read_word2vec_text, write_word2vec_binary, write_word2vec_text,
)

__all__ = ["BertIterator", "BertWordPieceTokenizer", "build_vocab",
           "Word2Vec", "distributed_word2vec_fit", "GloVe",
           "LabelledDocument", "ParagraphVectors", "StaticWordVectors",
           "load_static_model", "read_word2vec_binary", "read_word2vec_text",
           "write_word2vec_binary", "write_word2vec_text"]
