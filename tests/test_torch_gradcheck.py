"""``check_gradients`` for networks in the PyTorch port against the JAX
package (CPU): the same verdicts on the same networks (the JAX
parameters carried across) — a dense net under the ``DuelingQLayer``
head, a small CNN and a masked LSTM tagger — both passing at the default
1e-5 bound in float64, and both failing at a bound no finite difference
meets (1e-14); a network with no loss is refused."""

import jax
import numpy as np
import pytest

from deeplearning4j_tpu import nn as jnn
from deeplearning4j_tpu.autodiff import check_gradients as jcheck
from deeplearning4j_tpu_torch import nn as tnn
from deeplearning4j_tpu_torch.autodiff import check_gradients as tcheck


def dueling(pkg):
    return (pkg.builder().seed(3).list()
            .layer(pkg.DenseLayer(n_out=6, activation="tanh"))
            .layer(pkg.DuelingQLayer(n_actions=3, activation="identity"))
            .layer(pkg.LossLayer(loss="mse", activation="identity"))
            .set_input_type(pkg.InputType.feed_forward(4)).build())


def cnn(pkg):
    return (pkg.builder().seed(5).list()
            .layer(pkg.ConvolutionLayer(n_out=3, kernel=(3, 3),
                                        activation="tanh"))
            .layer(pkg.SubsamplingLayer(kernel=(2, 2), stride=(2, 2)))
            .layer(pkg.OutputLayer(n_out=4, activation="softmax",
                                   loss="mcxent"))
            .set_input_type(pkg.InputType.convolutional(6, 6, 2)).build())


def tagger(pkg):
    return (pkg.builder().seed(7).list()
            .layer(pkg.LSTM(n_out=5, activation="tanh"))
            .layer(pkg.RnnOutputLayer(n_out=3, activation="softmax",
                                      loss="mcxent"))
            .set_input_type(pkg.InputType.recurrent(4)).build())


def _data(name):
    rng = np.random.RandomState(1)
    if name == "dueling":
        return rng.randn(5, 4), rng.randn(5, 3), None
    if name == "cnn":
        return rng.randn(3, 6, 6, 2), np.eye(4)[rng.randint(4, size=3)], None
    lm = np.ones((3, 5))
    lm[0, 3:] = 0
    return rng.randn(3, 5, 4), np.eye(3)[rng.randint(3, size=(3, 5))], lm


CONFS = {"dueling": dueling, "cnn": cnn, "tagger": tagger}


@pytest.mark.parametrize("name", sorted(CONFS))
def test_check_gradients_verdicts_match_jax(name, capsys):
    jconf = CONFS[name](jnn)
    jnet = jnn.MultiLayerNetwork(jconf).init()
    tnet = tnn.MultiLayerNetwork(
        tnn.MultiLayerConfiguration.from_json(jconf.to_json()),
        device="cpu").init(params=jax.tree.map(np.asarray, jnet.params))
    x, y, lm = _data(name)
    kw = dict(labels_mask=lm, max_per_param=6, seed=2)
    assert jcheck(jnet, x, y, **kw) is True
    assert tcheck(tnet, x, y, **kw) is True
    assert "GRADCHECK FAIL" not in capsys.readouterr().out
    strict = dict(kw, max_rel_error=1e-14, min_abs_error=0.0,
                  max_per_param=2)
    assert jcheck(jnet, x, y, **strict) is False
    assert tcheck(tnet, x, y, **strict) is False
    fails = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("GRADCHECK FAIL")]
    assert fails
    # the parameters themselves are untouched (float32, as they were)
    assert all(v.dtype == np.float32 for v in jax.tree.leaves(
        jax.tree.map(lambda t: t.numpy(), tnet.params)))


def test_check_gradients_refuses_a_network_without_a_loss():
    conf = (tnn.builder().list()
            .layer(tnn.DenseLayer(n_in=3, n_out=2, activation="tanh"))
            .build())
    net = tnn.MultiLayerNetwork(conf, device="cpu").init()
    with pytest.raises(ValueError, match="no loss"):
        tcheck(net, np.ones((2, 3)), np.ones((2, 2)))
