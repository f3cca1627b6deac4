"""The port's mixture-of-experts layer (``nn/moe_layer.py``) and
expert-parallel ``moe_forward`` (``parallel/moe.py``) against the JAX
package's, on the same numpy inputs and the JAX package's parameters.

Tolerances: forward rtol 1e-5 / atol 1e-6 (float32), gradients 1e-4 (JAX
``tests/test_pipeline_moe.py:114`` holds its MoE to 1e-4). Routes are
asserted first: a float32 softmax an ulp apart could send a near-tie
elsewhere, so the inputs are drawn with the top gates apart.
"""

import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deeplearning4j_tpu import nn as jnn
from deeplearning4j_tpu.nn import conf as JC
from deeplearning4j_tpu.nn import graph as jgraph
from deeplearning4j_tpu.parallel.moe import init_moe_params as j_init_moe
from deeplearning4j_tpu.parallel.moe import moe_forward as j_moe_forward
from deeplearning4j_tpu_torch import nn as tnn
from deeplearning4j_tpu_torch.nn import conf as TC
from deeplearning4j_tpu_torch.testing.dist_group import run_group

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-4)
CASES = "deeplearning4j_tpu_torch.testing.parallel_cases"


def _conf(pkg, top_k, cf, e=4, d=8):
    b = pkg.builder().seed(5).updater(pkg.Adam(learning_rate=5e-3)).list()
    b.layer(pkg.DenseLayer(n_out=d, activation="relu"))
    b.layer(pkg.MoELayer(d_hidden=16, n_experts=e, top_k=top_k,
                         capacity_factor=cf, activation="relu"))
    b.layer(pkg.OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
    return b.set_input_type(pkg.InputType.feed_forward(d)).build()


def _nets(top_k, cf):
    jnet = jnn.MultiLayerNetwork(_conf(jnn, top_k, cf)).init()
    tnet = tnn.MultiLayerNetwork(
        tnn.MultiLayerConfiguration.from_json(jnet.conf.to_json()),
        device="cpu").init(jax.tree.map(np.asarray, jnet.params))
    return jnet, tnet


def _tokens(p, n=32, d=8, seed=0, gap=1e-3):
    """Tokens whose top-3 gates are at least ``gap`` apart under the
    router ``p["Weg"]`` (a near-tie could route differently)."""
    r = np.random.RandomState(seed)
    out = []
    while len(out) < n:
        x = r.randn(d).astype(np.float32)
        logits = x @ np.asarray(p["Weg"], np.float64)
        top = np.sort(logits)[::-1]
        if top[0] - top[1] > gap and top[1] - top[2] > gap:
            out.append(x)
    return np.stack(out)


CONFIGS = {"top1_ample": (1, 8.0), "top2_ample": (2, 8.0),
           "top1_drops": (1, 0.5), "top2_drops": (2, 0.5)}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_layer_forward_gradients_aux_and_drops(name):
    top_k, cf = CONFIGS[name]
    jnet, tnet = _nets(top_k, cf)
    jl, tl = jnet.layers[1], tnet.layers[1]
    p = jax.tree.map(np.asarray, jnet.params[1])
    x = _tokens(p)
    c = np.random.RandomState(1).randn(32, 8).astype(np.float32)

    def jloss(params, xx):
        y, st, _ = jl.apply(params, xx, jl.init_state(), train=True,
                            rng=None)
        return jnp.sum(y * c) + st["_aux_loss"], (y, st)

    (jval, (jy, jst)), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(
            jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    tx = torch.tensor(x, requires_grad=True)
    ty, tst, _ = tl.apply(tp, tx, tl.init_state(), train=True, rng=None)
    loss = torch.sum(ty * torch.from_numpy(c)) + tst["_aux_loss"]
    grads = torch.autograd.grad(loss, [tp[k] for k in sorted(tp)] + [tx])
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), **FWD)
    np.testing.assert_allclose(float(tst["_aux_loss"].detach()),
                               float(jst["_aux_loss"]), **FWD)
    assert float(tst["_dropped_frac"]) == float(jst["_dropped_frac"])
    if cf < 1:
        assert 0 < float(tst["_dropped_frac"]) < 1
        # a token with every assignment dropped passes through unchanged
        through = np.all(ty.detach().numpy() == x, axis=1)
        assert through.any()
        np.testing.assert_array_equal(through, np.all(np.asarray(jy) == x,
                                                      axis=1))
    else:
        assert float(tst["_dropped_frac"]) == 0.0
    for k, g in zip(sorted(tp), grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jgp[k]), **GRAD,
                                   err_msg=k)
    np.testing.assert_allclose(grads[-1].numpy(), np.asarray(jgx), **GRAD)
    # outside training the aux loss is zero, the drop share still counted
    _, est, _ = tl.apply({k: v.detach() for k, v in tp.items()},
                         tx.detach(), tl.init_state(), train=False, rng=None)
    assert float(est["_aux_loss"]) == 0.0
    assert float(est["_dropped_frac"]) == float(tst["_dropped_frac"])


@pytest.mark.parametrize("top_k,cf", [(1, 0.5), (2, 2.0)])
def test_two_adam_steps_of_a_network_carrying_it(top_k, cf):
    jnet, tnet = _nets(top_k, cf)
    r = np.random.RandomState(2)
    x = r.randn(32, 8).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[r.randint(0, 3, 32)]
    np.testing.assert_allclose(tnet.output(x), np.asarray(jnet.output(x)),
                               **FWD)
    for _ in range(2):
        jnet.fit(x, y)
        tnet.fit(x, y)
        # the aux loss is in the training loss
        assert tnet.score() == pytest.approx(jnet.score(), rel=1e-5)
    np.testing.assert_allclose(tnet.params_flat(),
                               np.asarray(jnet.params_flat()), **GRAD)
    np.testing.assert_allclose(tnet.updater_state_flat(),
                               np.asarray(jnet.updater_state_flat()), **GRAD)
    for k in ("_aux_loss", "_dropped_frac"):
        np.testing.assert_allclose(float(tnet.net_state[1][k]),
                                   float(jnet.net_state[1][k]), rtol=1e-5)
    assert float(tnet.net_state[1]["_aux_loss"]) > 0


def _graph_conf(pkg, builder):
    b = (builder().seed(2).updater(pkg.Adam(learning_rate=5e-3))
         .add_inputs("in")
         .set_input_types(**{"in": pkg.InputType.feed_forward(8)}))
    b.add_layer("d", pkg.DenseLayer(n_out=8, activation="relu"), "in")
    b.add_layer("moe", pkg.MoELayer(d_hidden=16, n_experts=4, top_k=2,
                                    capacity_factor=1.0,
                                    activation="relu"), "d")
    b.add_layer("out", pkg.OutputLayer(n_out=3, activation="softmax",
                                       loss="mcxent"), "moe")
    b.set_outputs("out")
    return b.build()


def test_two_adam_steps_of_a_graph_carrying_it():
    """The graph's train step adds the layer's aux loss too (JAX
    ``tests/test_parallel_product.py:242``)."""
    jnet = jgraph.ComputationGraph(_graph_conf(jnn, jgraph.graph_builder))
    jnet.init()
    tnet = tnn.ComputationGraph(
        tnn.ComputationGraphConfiguration.from_json(jnet.conf.to_json()),
        device="cpu").init(jax.tree.map(np.asarray, jnet.params))
    r = np.random.RandomState(9)
    x = r.randn(32, 8).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[r.randint(0, 3, 32)]
    for _ in range(2):
        jnet.fit(x, y)
        tnet.fit(x, y)
        assert tnet.score() == pytest.approx(jnet.score(), rel=1e-5)
    for k in jnet.params:
        for leaf in jnet.params[k]:
            np.testing.assert_allclose(
                tnet.params[k][leaf].detach().numpy(),
                np.asarray(jnet.params[k][leaf]), **GRAD, err_msg=k + leaf)
    st = tnet.net_state["moe"]
    assert float(st["_aux_loss"]) == pytest.approx(
        float(jnet.net_state["moe"]["_aux_loss"]), rel=1e-5)
    assert 0.0 <= float(st["_dropped_frac"]) <= 1.0


def test_json_round_trip():
    lc = jnn.MoELayer(n_in=8, d_hidden=16, n_experts=4, top_k=2)
    own = TC.LayerConf.from_dict(json.loads(json.dumps(lc.to_dict())))
    assert own == tnn.MoELayer(n_in=8, d_hidden=16, n_experts=4, top_k=2)
    assert own.to_dict() == lc.to_dict()
    assert JC.LayerConf.from_dict(own.to_dict()) == lc
    conf = _conf(jnn, 2, 1.25)
    back = tnn.MultiLayerConfiguration.from_json(conf.to_json())
    assert json.loads(back.to_json()) == json.loads(conf.to_json())


# ---------------------------------------------------------------------------
# moe_forward over 2 and 4 gloo ranks against the JAX shard_map version
# ---------------------------------------------------------------------------

EP_CASES = {"ample": (8, 8.0), "drops": (4, 1.0)}


def _ep_inputs(world, name):
    e, cf = EP_CASES[name]
    params = jax.tree.map(np.array, j_init_moe(jax.random.key(world), e,
                                                6, 8))
    r = np.random.RandomState(world)
    x = r.randn(16 * world, 6).astype(np.float32)
    if name == "drops":  # most tokens to expert 0: drops on every rank
        params["router"][:, 0] += 2.0
        x = np.abs(x)
    c = r.randn(16 * world, 6).astype(np.float32)
    return params, x, c, e, cf


@pytest.fixture(scope="module", params=(2, 4), ids=lambda w: f"ranks{w}")
def ep_group(request, tmp_path_factory):
    world = request.param
    cases = []
    for name in EP_CASES:
        params, x, c, e, cf = _ep_inputs(world, name)
        cases.append((name, f"{CASES}:moe_forward_case", dict(
            params=params, x=x, c=c, n_experts=e, capacity_factor=cf,
            world=world)))
    out = run_group(str(tmp_path_factory.mktemp(f"moe{world}")), world,
                    cases, threads=max(1, torch.get_num_threads() // world))
    return world, out


@pytest.mark.parametrize("name", sorted(EP_CASES))
def test_moe_forward_matches_jax_shard_map(ep_group, name):
    world, out = ep_group
    params, x, c, e, cf = _ep_inputs(world, name)
    from jax.sharding import Mesh

    mesh = Mesh(np.array(jax.devices()[:world]), ("expert",))
    fwd = j_moe_forward(mesh, n_experts=e, capacity_factor=cf)

    def loss(p):
        y, aux = fwd(p, jnp.asarray(x))
        return jnp.sum(y * c) + 0.01 * aux, (y, aux)

    (_, (jy, jaux)), jg = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jax.tree.map(jnp.asarray, params))
    n = x.shape[0] // world
    per = e // world
    for r, res in enumerate(out):
        got = res[name]
        np.testing.assert_allclose(got["y"], np.asarray(jy)[r * n:(r + 1) * n],
                                   **FWD)
        assert got["aux"] == pytest.approx(float(jaux), rel=1e-5)
        np.testing.assert_allclose(got["grads"]["router"],
                                   np.asarray(jg["router"]), **GRAD)
        for k in ("W1", "W2"):
            np.testing.assert_allclose(
                got["grads"][k], np.asarray(jg[k])[r * per:(r + 1) * per],
                **GRAD, err_msg=k)
    if name == "drops":
        passed = np.all(np.concatenate([res[name]["y"] for res in out]) == x,
                        axis=1)
        assert passed.sum() >= x.shape[0] // 2
