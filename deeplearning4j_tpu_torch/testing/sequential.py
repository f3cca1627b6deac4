"""The sequential network's card workloads: configurations and data.

Three networks through ``MultiLayerNetwork``, at the widths their sources
use, with data drawn from a seed (no downloads), shared by
``chip_smoke.py``'s ``lenet``, ``bilstm_tagger`` and ``char_lstm`` phases
and by ``profile_mln``:

* LeNet (``models.LeNet()`` at its zoo defaults) on batches of 64
  synthetic 28×28 digits, dl4j-examples' LeNet MNIST batch;
* BASELINE config 3, a BiLSTM sequence tagger: 300-wide word vectors and
  a 256-unit LSTM each way (dl4j-examples' Word2VecSentimentRNN), the 9
  BIO tags of CoNLL-2003, Adam 5e-3; batch 32 × T 128 with ragged
  lengths 8…128, features and labels masks right padded;
* the layers of ``TextGenerationLSTM(vocab_size=77)`` (2 × LSTM 256,
  RmsProp 1e-2, seed 123) with truncated BPTT 50, on 32 × 1000 one-hot
  characters (dl4j-examples' character-modelling LSTM: minibatch 32,
  example length 1000, tBPTT 50); the same layers as a ComputationGraph
  for ``graph_tbptt``.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

LENET = dict(batch=64, steps=3)
TAGGER = dict(batch=32, seq=128, min_len=8, features=300, hidden=256,
              tags=9, steps=3)
CHAR = dict(batch=32, seq=1000, vocab=77, hidden=256, tbptt=50)


def lenet_batches(batch: int, steps: int) -> List:
    """``steps`` DataSets of ``batch`` flat 28×28 synthetic digits."""
    from deeplearning4j_tpu_torch.datasets import (
        DataSet, synthetic_image_batch)

    out = []
    for i in range(steps):
        x, lab = synthetic_image_batch(batch, 28, 28, 1, 10, seed=140 + i)
        out.append(DataSet(x.reshape(batch, -1),
                           np.eye(10, dtype=np.float32)[lab]))
    return out


def tagger_conf(features: int, hidden: int, tags: int):
    from deeplearning4j_tpu_torch import nn

    return (nn.builder().seed(7).updater(nn.Adam(learning_rate=5e-3))
            .list()
            .layer(nn.Bidirectional.wrap(
                nn.LSTM(n_out=hidden, activation="tanh"), "concat"))
            .layer(nn.RnnOutputLayer(n_out=tags, activation="softmax",
                                     loss="mcxent"))
            .set_input_type(nn.InputType.recurrent(features)).build())


def tagger_batches(batch: int, seq: int, min_len: int, features: int,
                   tags: int, steps: int) -> Tuple[List, List[int]]:
    """``steps`` DataSets of word vectors and one-hot tags with ragged
    lengths ``min_len``…``seq`` (the first row full), features and labels
    zero past each row's length; and the real tokens of each."""
    from deeplearning4j_tpu_torch.datasets import DataSet

    batches, real = [], []
    for i in range(steps):
        rng = np.random.default_rng(40 + i)
        lengths = rng.integers(min_len, seq + 1, batch)
        lengths[0] = seq
        m = (np.arange(seq)[None, :] < lengths[:, None]).astype(np.float32)
        x = rng.standard_normal((batch, seq, features),
                                dtype=np.float32) * m[..., None]
        y = np.eye(tags, dtype=np.float32)[rng.integers(0, tags,
                                                        (batch, seq))]
        batches.append(DataSet(x, y * m[..., None], m, m))
        real.append(int(lengths.sum()))
    return batches, real


def char_graph_conf(vocab: int, hidden: int, tbptt: int):
    """:func:`char_conf`'s layers as a ComputationGraph (``graph_builder``:
    l0 → l1 → out), truncated BPTT set on the configuration as the JAX
    graph takes it."""
    from deeplearning4j_tpu_torch import nn
    from deeplearning4j_tpu_torch.nn.graph import graph_builder

    conf = (graph_builder().seed(123).updater(nn.RmsProp(learning_rate=1e-2))
            .weight_init("xavier").add_inputs("in")
            .set_input_types(**{"in": nn.InputType.recurrent(vocab)})
            .add_layer("l0", nn.LSTM(n_out=hidden, activation="tanh"), "in")
            .add_layer("l1", nn.LSTM(n_out=hidden, activation="tanh"), "l0")
            .add_layer("out", nn.RnnOutputLayer(
                n_out=vocab, activation="softmax", loss="mcxent"), "l1")
            .set_outputs("out").build())
    conf.backprop_type = "tbptt"
    conf.tbptt_fwd_length = conf.tbptt_back_length = tbptt
    return conf


def char_conf(vocab: int, hidden: int, tbptt: int):
    from deeplearning4j_tpu_torch import nn

    return (nn.builder().seed(123).updater(nn.RmsProp(learning_rate=1e-2))
            .weight_init("xavier").tbptt(tbptt, tbptt).list()
            .layer(nn.LSTM(n_out=hidden, activation="tanh"))
            .layer(nn.LSTM(n_out=hidden, activation="tanh"))
            .layer(nn.RnnOutputLayer(n_out=vocab, activation="softmax",
                                     loss="mcxent"))
            .set_input_type(nn.InputType.recurrent(vocab)).build())


def char_batch(batch: int, seq: int, vocab: int, seed: int = 77):
    """One DataSet of one-hot characters, each labelled with the next."""
    from deeplearning4j_tpu_torch.datasets import DataSet

    chars = np.random.default_rng(seed).integers(0, vocab, (batch, seq + 1))
    eye = np.eye(vocab, dtype=np.float32)
    return DataSet(eye[chars[:, :-1]], eye[chars[:, 1:]])
