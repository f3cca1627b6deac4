"""SameDiff ``to_dict`` / ``save`` / ``load`` of the port against the JAX
package (CPU).

The same graph is built through both packages' SameDiff API (one builder,
two classes) from the same numpy arrays. A zip either package writes
(``graph.json``, ``meta.json``, ``arrays.npz`` and, when asked,
``updater.npz``) loads in the other and gives the same outputs: float32
to 1e-6 relative (the same ops on the same numbers, summed in another
order by another library); arrays and the updater state bit for bit.

bfloat16 variables: ``np.savez`` stores an ``ml_dtypes.bfloat16`` array
as raw two-byte records, and the JAX package's ``load`` hands those to
``jnp.asarray``, which refuses them: the JAX package cannot load a zip
holding a bfloat16 array, its own or the port's (ROADMAP.md, "Not port
faults"). So bfloat16 is held by bytes: the port reads the JAX zip's
records back as the same bfloat16 values, and writes the same records.
"""

import io
import zipfile

import ml_dtypes
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.autodiff.samediff import SameDiff as JSameDiff
from deeplearning4j_tpu.autodiff.samediff import TrainingConfig as JTC
from deeplearning4j_tpu.nn.updater import Adam as JAdam
from deeplearning4j_tpu_torch.autodiff import SameDiff as TSameDiff
from deeplearning4j_tpu_torch.autodiff import TrainingConfig as TTC
from deeplearning4j_tpu_torch.nn.updater import Adam as TAdam

TOL = dict(rtol=1e-6, atol=1e-7)


class Batch:
    def __init__(self, features, labels):
        self.features, self.labels = features, labels

    def num_examples(self):
        return int(self.labels.shape[0])


def _mlp(pkg, bf16=False):
    """x (4, 8) → dense+tanh → dense → softmax; a constant shift; with
    ``bf16`` a bfloat16 variable scales the logits."""
    r = np.random.RandomState(0)
    sd = JSameDiff() if pkg == "jax" else TSameDiff(device="cpu")
    x = sd.placeholder("x", (4, 8))
    sd.placeholder("labels", (4, 3))
    w1 = sd.var("w1", (r.randn(8, 16) * 0.3).astype(np.float32))
    b1 = sd.var("b1", (r.randn(16) * 0.1).astype(np.float32))
    w2 = sd.var("w2", (r.randn(16, 3) * 0.3).astype(np.float32))
    shift = sd.constant("shift", np.float32(0.25))
    h = sd.math.tanh(x @ w1 + b1)
    logits = h @ w2 + shift
    if bf16:
        g = sd.var("g_bf16", (r.rand(3) + 0.5).astype(ml_dtypes.bfloat16))
        logits = logits * g
    logits.rename("logits")
    sd.nn.softmax(logits, axis=-1).rename("out")
    feeds = {"x": r.randn(4, 8).astype(np.float32)}
    labels = np.eye(3, dtype=np.float32)[r.randint(0, 3, 4)]
    return sd, feeds, labels


def _train(sd, pkg):
    """Set Adam lr 1e-2 on ``loss``, recording the loss node unless the
    graph (a loaded one) holds it."""
    TC, Adam = (JTC, JAdam) if pkg == "jax" else (TTC, TAdam)
    if "loss" not in sd._vars:
        sd.loss.softmax_cross_entropy(sd.get_variable("logits"),
                                      sd.get_variable("labels")
                                      ).rename("loss")
    sd.set_training_config(TC(updater=Adam(learning_rate=1e-2),
                              data_set_feature_mapping=["x"],
                              data_set_label_mapping=["labels"],
                              loss_variables=["loss"]))


def _load(pkg, path):
    return JSameDiff.load(path) if pkg == "jax" else \
        TSameDiff.load(path, device="cpu")


def _zip_arrays(path, member="arrays.npz"):
    with zipfile.ZipFile(path) as z:
        npz = np.load(io.BytesIO(z.read(member)))
        return {k: npz[k] for k in npz.files}


@pytest.mark.parametrize("src,dst", [("jax", "torch"), ("torch", "jax")])
def test_float32_zip_loads_in_the_other_package(tmp_path, src, dst):
    sd, feeds, _ = _mlp(src)
    want = np.asarray(sd.output(feeds, ["out"])["out"])
    path = str(tmp_path / "g.zip")
    sd.save(path)
    with zipfile.ZipFile(path) as z:
        assert sorted(z.namelist()) == ["arrays.npz", "graph.json",
                                        "meta.json"]
    other = _load(dst, path)
    assert other.to_dict() == sd.to_dict()
    got = np.asarray(other.output(feeds, ["out"])["out"])
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, **TOL)
    mine, _, _ = _mlp(dst)
    np.testing.assert_allclose(
        np.asarray(mine.output(feeds, ["out"])["out"]), got, **TOL)


def test_the_zips_hold_the_same_graph_and_arrays(tmp_path):
    (jsd, _, _), (tsd, _, _) = _mlp("jax"), _mlp("torch")
    jsd.save(str(tmp_path / "j.zip"))
    tsd.save(str(tmp_path / "t.zip"))
    assert tsd.to_dict() == jsd.to_dict()
    ja, ta = _zip_arrays(tmp_path / "j.zip"), _zip_arrays(tmp_path / "t.zip")
    assert sorted(ja) == sorted(ta) == ["b1", "shift", "w1", "w2"]
    for k in ja:
        assert ta[k].dtype == ja[k].dtype and ta[k].shape == ja[k].shape
        np.testing.assert_array_equal(ta[k], ja[k])


def test_bfloat16_variable_round_trips_by_bytes(tmp_path):
    jsd, feeds, _ = _mlp("jax", bf16=True)
    jpath = str(tmp_path / "j.zip")
    jsd.save(jpath)
    tsd = TSameDiff.load(jpath, device="cpu")
    g = tsd._arrays["g_bf16"]
    assert g.dtype == torch.bfloat16 and tsd.get_variable(
        "g_bf16").dtype == torch.bfloat16
    want_bits = np.asarray(jsd._arrays["g_bf16"]).view(np.uint16)
    np.testing.assert_array_equal(g.view(torch.int16).numpy().view(
        np.uint16), want_bits)
    got = tsd.output(feeds, ["out"])["out"]
    np.testing.assert_allclose(got, np.asarray(jsd.output(feeds, ["out"])[
        "out"]), **TOL)
    # the port writes the records it read, and reads its own zip back
    tpath = str(tmp_path / "t.zip")
    tsd.save(tpath)
    ja, ta = _zip_arrays(jpath), _zip_arrays(tpath)
    assert ta["g_bf16"].dtype == ja["g_bf16"].dtype == np.dtype("V2")
    assert ta["g_bf16"].tobytes() == ja["g_bf16"].tobytes()
    again = TSameDiff.load(tpath, device="cpu")
    assert torch.equal(again._arrays["g_bf16"], g)
    np.testing.assert_array_equal(again.output(feeds, ["out"])["out"], got)
    # the JAX package refuses a bfloat16 record, in its zip and the port's
    for path in (jpath, tpath):
        with pytest.raises(TypeError, match="V2"):
            JSameDiff.load(path)


@pytest.mark.parametrize("src,dst", [("jax", "torch"), ("torch", "jax")])
def test_updater_state_after_one_fit_step_crosses_over(tmp_path, src, dst):
    """One Adam step in ``src``, saved with its updater state, loaded in
    ``dst``: parameters, Adam moments and the step carried across; one
    more step there equals the same second step in ``src``."""
    sd, feeds, labels = _mlp(src)
    _train(sd, src)
    b = Batch([feeds["x"]], labels)
    sd.fit([b])
    path = str(tmp_path / "g.zip")
    sd.save(path, save_updater_state=True)
    with zipfile.ZipFile(path) as z:
        assert "updater.npz" in z.namelist()
    upd = _zip_arrays(path, "updater.npz")
    assert sorted(upd) == sorted(f"{n}::{k}" for n in ("b1", "w1", "w2")
                                 for k in ("m", "v"))
    other = _load(dst, path)
    assert other._step == sd._step == 1
    for n, st in other._updater_state.items():
        for k, v in st.items():
            np.testing.assert_array_equal(np.asarray(v), upd[f"{n}::{k}"])
    _train(other, dst)
    want = sd.fit([b])
    got = other.fit([b])
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for n in ("w1", "b1", "w2"):
        np.testing.assert_allclose(np.asarray(other.get_arr(n)),
                                   np.asarray(sd.get_arr(n)),
                                   rtol=1e-6, atol=1e-7, err_msg=n)


def test_without_updater_state_the_zip_has_none(tmp_path):
    sd, feeds, labels = _mlp("torch")
    _train(sd, "torch")
    sd.fit([Batch([feeds["x"]], labels)])
    path = str(tmp_path / "g.zip")
    sd.save(path)
    with zipfile.ZipFile(path) as z:
        assert "updater.npz" not in z.namelist()
    loaded = TSameDiff.load(path, device="cpu")
    assert loaded._updater_state is None and loaded._step == 1


def test_control_flow_graph_refuses_to_save(tmp_path):
    sd = TSameDiff(device="cpu")
    x = sd.placeholder("x", (3,))
    sd.scan(lambda c, xs: (c + xs, c), sd.constant("c0", np.float32(0.0)),
            x)
    with pytest.raises(ValueError, match="control-flow"):
        sd.save(str(tmp_path / "g.zip"))
