"""The port's parallel package against the JAX package's (``parallel/mesh.py``
and ``launch.py``).

The JAX package runs its mesh on the 8 virtual CPU devices of this
process (``tests/conftest.py``); the port runs one process a rank, joined
over gloo: one group of 2 ranks and one of 4 (``testing/dist_group.py``),
each started once for this module and running every case
(``testing/parallel_cases.py``) in turn. Each case starts from the JAX
package's parameters. What the ranks return is held here against the JAX
``ParallelWrapper`` step on its 8-device mesh over the same global batch
(rtol 2e-4 / atol 1e-5, JAX ``tests/test_parallel.py:70``), or against
the JAX replicated step where the JAX test holds its sharded run to that.
"""

import logging
import threading

import numpy as np
import pytest

import jax
import torch

from deeplearning4j_tpu import nn as jnn
from deeplearning4j_tpu.datasets import DataSet as JDataSet
from deeplearning4j_tpu.parallel import ParallelWrapper as JParallelWrapper
from deeplearning4j_tpu.parallel import make_mesh as jmake_mesh
from deeplearning4j_tpu_torch import faults
from deeplearning4j_tpu_torch import nn as tnn
from deeplearning4j_tpu_torch.parallel import (
    DEFAULT_TP_RULES, ParallelInference, ParallelWrapper, make_mesh)
from deeplearning4j_tpu_torch.testing.dist_group import run_group

CASES = "deeplearning4j_tpu_torch.testing.parallel_cases"
RTOL, ATOL = 2e-4, 1e-5
WORLDS = (2, 4)


def _small(pkg, seed=12):
    return (pkg.builder().seed(seed).updater(pkg.Adam(learning_rate=0.02))
            .weight_init("xavier").list()
            .layer(pkg.DenseLayer(n_out=32, activation="tanh"))
            .layer(pkg.OutputLayer(n_out=2, activation="softmax",
                                   loss="mcxent"))
            .set_input_type(pkg.InputType.feed_forward(2)).build())


def _bn(pkg):
    return (pkg.builder().seed(3).updater(pkg.Adam(learning_rate=0.01))
            .list()
            .layer(pkg.DenseLayer(n_out=16, activation="relu"))
            .layer(pkg.BatchNormalization())
            .layer(pkg.OutputLayer(n_out=3, activation="softmax",
                                   loss="mcxent"))
            .set_input_type(pkg.InputType.feed_forward(6)).build())


def _moe(pkg, cf=0.5):
    # capacity factor 0.5: assignments dropped, tokens passed through
    return (pkg.builder().seed(5).updater(pkg.Adam(learning_rate=5e-3))
            .list()
            .layer(pkg.DenseLayer(n_out=8, activation="relu"))
            .layer(pkg.MoELayer(d_hidden=16, n_experts=4, top_k=2,
                                capacity_factor=cf, activation="relu"))
            .layer(pkg.OutputLayer(n_out=3, activation="softmax",
                                   loss="mcxent"))
            .set_input_type(pkg.InputType.feed_forward(8)).build())


def _batches(n_in, n_out, rows=32, steps=2, seed=0):
    r = np.random.RandomState(seed)
    return [(r.randn(rows, n_in).astype(np.float32),
             np.eye(n_out, dtype=np.float32)[r.randint(0, n_out, rows)])
            for _ in range(steps)]


def _jax_net(conf):
    return jnn.MultiLayerNetwork(conf).init()


def _params(jnet):
    return jax.tree.map(np.asarray, jnet.params)


NETS = {"small": (_small, 2, 2), "bn": (_bn, 6, 3), "moe": (_moe, 8, 3)}


def _setup():
    """The JAX networks, their initial parameters and batches, shared by
    the cases and the JAX references."""
    out = {}
    for name, (build, n_in, n_out) in NETS.items():
        jnet = _jax_net(build(jnn))
        out[name] = (jnet.conf.to_json(), _params(jnet),
                     _batches(n_in, n_out, seed=len(name)))
    r = np.random.RandomState(9)
    out["ragged"] = (out["small"][0], out["small"][1],
                     [(r.randn(11, 2).astype(np.float32),
                       np.eye(2, dtype=np.float32)[r.randint(0, 2, 11)])])
    return out


SETUP = None


def _inputs():
    global SETUP
    if SETUP is None:
        SETUP = _setup()
    return SETUP


def _cases(world):
    s = _inputs()
    half = {"data": world // 2}
    small_conf, small_params, _ = s["small"]
    r = np.random.RandomState(4)
    ex = r.rand(64, 2).astype(np.float32)
    ey = np.eye(2, dtype=np.float32)[(ex[:, 0] > ex[:, 1]).astype(int)]
    split = [6, 5] if world == 2 else [3, 3, 3, 2]

    def fit(name, net, **kw):
        conf, params, batches = s[net]
        return (name, f"{CASES}:fit_case", dict(
            kind="mln", conf_json=conf, params=params, batches=batches,
            **kw))

    return [
        ("collectives", f"{CASES}:collectives_case", {"world": world}),
        ("mesh", f"{CASES}:mesh_case", {"world": world}),
        ("shard", f"{CASES}:shard_case", dict(
            conf_json=small_conf, params=small_params,
            axes=dict(half, model=2), rules="tp")),
        fit("dp_bn", "bn"),
        fit("dp_moe", "moe", hlo=True),
        fit("dp_small", "small"),
        fit("tp_small", "small", axes=dict(half, model=2), rules="tp",
            hlo=True),
        fit("ep_moe", "moe", axes=dict(half, expert=2), rules="ep",
            hlo=True),
        fit("ragged", "ragged", split=split),
        ("data", f"{CASES}:data_case", dict(
            conf_json=small_conf, params=small_params, x=ex, y=ey)),
        ("inference", f"{CASES}:inference_case", dict(
            conf_json=small_conf, params=small_params, x=ex[:13])),
    ]


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"ranks{w}")
def group(request, tmp_path_factory):
    world = request.param
    threads = max(1, torch.get_num_threads() // world)
    out = run_group(str(tmp_path_factory.mktemp(f"group{world}")), world,
                    _cases(world), threads=threads)
    return world, out


def _jax_pw(name, epochs=1):
    """The JAX ParallelWrapper over the 8-device mesh, each global batch
    one step."""
    conf, params, batches = _inputs()[name]
    jnet = jnn.MultiLayerNetwork(jnn.MultiLayerConfiguration.from_json(conf))
    jnet.init()
    jnet.params = jax.tree.map(jax.numpy.asarray, params)
    losses = []

    class Record:
        def on_epoch_start(self, net):
            pass

        def on_epoch_end(self, net):
            pass

        def iteration_done(self, net, it, ep, loss):
            losses.append(float(loss))

    jnet.set_listeners(Record())
    pw = JParallelWrapper(jnet, mesh=jmake_mesh({"data": 8}))
    pw.fit([JDataSet(x, y) for x, y in batches], epochs=epochs)
    return jnet, losses


def _jax_fit(name):
    """The JAX replicated run: plain ``fit`` a batch."""
    conf, params, batches = _inputs()[name]
    jnet = jnn.MultiLayerNetwork(jnn.MultiLayerConfiguration.from_json(conf))
    jnet.init()
    jnet.params = jax.tree.map(jax.numpy.asarray, params)
    for x, y in batches:
        jnet.fit(x, y, batch_size=x.shape[0])
    return jnet


def _assert_state(got, jnet, losses=None):
    np.testing.assert_allclose(got["params_flat"], np.asarray(
        jnet.params_flat()), rtol=RTOL, atol=ATOL)
    for mine, theirs in zip(got["net_state"], jnet.net_state):
        for k in theirs:
            np.testing.assert_allclose(mine[k], np.asarray(theirs[k]),
                                       rtol=RTOL, atol=ATOL, err_msg=k)
    if losses is not None:
        np.testing.assert_allclose(got["losses"], losses, rtol=RTOL,
                                   atol=ATOL)


def _every_rank(out, name):
    """The case's result, the same on every rank."""
    first = out[0][name]
    for other in out[1:]:
        np.testing.assert_array_equal(other[name]["params_flat"],
                                      first["params_flat"])
    return first


def test_collectives_and_their_adjoints(group):
    world, out = group
    for r, res in enumerate(out[:2]):
        c = res["collectives"]
        np.testing.assert_array_equal(c["sum"], [world * (world + 1) / 2] * 2)
        np.testing.assert_array_equal(c["gather"], np.repeat(
            np.arange(1, world + 1), 2))
        np.testing.assert_array_equal(c["shift"], [(r - 1) % world + 1] * 2)
        np.testing.assert_array_equal(c["a2a"][:, 0],
                                      [2 * r + 100 * j for j in range(world)])
        # d/dt of Σ_ranks (Σ sum + Σ i·gather_i + Σ shift)
        np.testing.assert_array_equal(
            c["grad"], world + world * np.arange(2 * r, 2 * r + 2) + 1)
        assert [op for op, _ in c["record"]] == [
            "all_reduce", "all_gather", "ring_shift", "all_to_all"]


def test_make_mesh_shapes_and_error(group):
    world, out = group
    for r, res in enumerate(out):
        m = res["mesh"]
        assert m["default"] == {"data": world}
        assert m["two_axes"] == {"data": world // 2, "model": 2}
        assert m["type"] == "DeviceMesh"
        assert m["coords"] == {"data": r // 2, "model": r % 2}
        assert m["error"] == (f"mesh axes {{'data': {world + 1}}} need "
                              f"{world + 1} devices, have {world}")


def test_make_mesh_one_rank_is_local():
    mesh = make_mesh(device="cpu")
    assert dict(zip(mesh.mesh_dim_names, mesh.shape)) == {"data": 1}
    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        make_mesh({"data": 2}, device="cpu")


def test_shard_params_placements_from_the_rules(group):
    world, out = group
    _, params, _ = _inputs()["small"]
    for res in out:
        sh = res["shard"]
        # W (2, 32) column-split over model; W of the output (32, 2)
        # split too; biases and the rest replicated
        assert sh["specs"] == {"/0/W": (None, "model"),
                               "/1/W": (None, "model")}
        m = sh["coords"]["model"]
        for i in (0, 1):
            np.testing.assert_array_equal(
                sh["local"][i]["W"], np.split(params[i]["W"], 2, axis=1)[m])
            np.testing.assert_array_equal(sh["local"][i]["b"],
                                          params[i]["b"])


def test_dp_batchnorm_step_equals_jax_mesh_step(group):
    """Batch statistics over the global batch (the sums all-reduced):
    parameters, running statistics and losses of the JAX 8-device step."""
    _, out = group
    jnet, losses = _jax_pw("bn")
    _assert_state(_every_rank(out, "dp_bn"), jnet, losses)


def test_dp_moe_step_with_drops_equals_jax_mesh_step(group):
    """Global capacity, global slot order, global aux loss and drop
    share: the MoE net with capacity drops against the JAX 8-device
    step."""
    _, out = group
    jnet, losses = _jax_pw("moe")
    got = _every_rank(out, "dp_moe")
    _assert_state(got, jnet, losses)
    assert 0.0 < float(got["net_state"][1]["_dropped_frac"]) < 1.0
    hlo = got["hlo"]
    assert "all_reduce over data" in hlo and "all_gather over data" in hlo


def test_dp_small_net_equals_jax_mesh_step(group):
    _, out = group
    jnet, losses = _jax_pw("small")
    got = _every_rank(out, "dp_small")
    _assert_state(got, jnet, losses)
    # the updater state too: every rank ran the same fused update
    np.testing.assert_allclose(
        got["opt_state"][0]["W"]["m"], np.asarray(jnet.opt_state[0]["W"]["m"]),
        rtol=RTOL, atol=ATOL)


def test_tp_rules_equal_replicated(group):
    """Leaves sharded by DEFAULT_TP_RULES (each rank holds half of each
    W during fit, gathered for the forward): the result of the
    replicated step."""
    _, out = group
    got = _every_rank(out, "tp_small")
    _assert_state(got, _jax_fit("small"))
    assert "all_gather over model" in got["hlo"]
    assert "all_reduce over data,model" in got["hlo"] or (
        "all_reduce over model" in got["hlo"])


def test_ep_rules_equal_replicated(group):
    """Experts sharded over the expert axis (moe_ep_rules): tokens reach
    them by all-to-all; the result of the replicated step."""
    _, out = group
    got = _every_rank(out, "ep_moe")
    _assert_state(got, _jax_fit("moe"))
    hlo = got["hlo"]
    assert "all_to_all over expert" in hlo
    assert "all_reduce over" in hlo


def test_ragged_batch_runs_replicated_and_warns_once(group):
    world, out = group
    got = _every_rank(out, "ragged")
    _assert_state(got, _jax_fit("ragged"))
    assert len(got["warnings"]) == 1 and "REPLICATED" in got["warnings"][0]


def test_sharded_iterator_host_shard_and_distributed_evaluate(group):
    world, out = group
    conf, params, _ = _inputs()["small"]
    r = np.random.RandomState(4)
    ex = r.rand(64, 2).astype(np.float32)
    ey = np.eye(2, dtype=np.float32)[(ex[:, 0] > ex[:, 1]).astype(int)]
    jnet = jnn.MultiLayerNetwork(jnn.MultiLayerConfiguration.from_json(conf))
    jnet.init()
    jnet.params = jax.tree.map(jax.numpy.asarray, params)
    want = jnet.evaluate(JDataSet(ex, ey))
    for rank, res in enumerate(out):
        d = res["data"]
        assert d["host_shard"] == list(range(10))[rank::world]
        assert d["shard_first_rows"] == [ex[8 * b].tolist() for b in range(
            rank, 8, world)]
        np.testing.assert_array_equal(d["confusion"], want.confusion)
        assert d["accuracy"] == pytest.approx(want.accuracy())


def test_parallel_inference_output_gathers_every_rank(group):
    _, out = group
    for res in out:
        np.testing.assert_allclose(res["inference"]["output"],
                                   res["inference"]["direct"], rtol=1e-6,
                                   atol=1e-6)
        assert res["inference"]["output"].shape == (13, 2)


# ---------------------------------------------------------------------------
# One process: ParallelInference's serving loop, faults, the wrapper at
# world 1
# ---------------------------------------------------------------------------


def _port_small():
    conf, params, _ = _inputs()["small"]
    return tnn.MultiLayerNetwork(tnn.MultiLayerConfiguration.from_json(conf),
                                 device="cpu").init(params)


def test_parallel_inference_threads_equal_output():
    net = _port_small()
    pi = ParallelInference(net, max_batch=8, window_ms=3.0).start()
    r = np.random.RandomState(0)
    requests = [r.rand(1 + i % 3, 2).astype(np.float32) for i in range(48)]
    replies = [None] * len(requests)

    def client(k):
        for i in range(k, len(requests), 4):
            replies[i] = pi.predict(requests[i])

    threads = [threading.Thread(target=client, args=(k,)) for k in range(4)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        pi.stop()
    for x, y in zip(requests, replies):
        np.testing.assert_allclose(y, net.output(x), rtol=1e-6, atol=1e-6)
    # one example without its batch dim gets one row back
    np.testing.assert_allclose(pi.start().predict(requests[0][0]),
                               net.output(requests[0][:1]), rtol=1e-6,
                               atol=1e-6)
    pi.stop()
    x = r.rand(21, 2).astype(np.float32)
    np.testing.assert_allclose(pi.output(x), net.output(x), rtol=1e-6,
                               atol=1e-6)


def test_backend_init_fail_raises_at_start_and_fails_the_batch():
    net = _port_small()
    faults.reset()
    try:
        faults.arm("backend_init_fail", prob=1.0, max_fires=1)
        pi = ParallelInference(net)
        with pytest.raises(faults.InjectedFault):
            pi.start()
        assert pi._worker is None
        faults.arm("backend_init_fail", prob=1.0, after_n=1, max_fires=1)
        pi.start()
        with pytest.raises(faults.InjectedFault):
            pi.predict(np.zeros((1, 2), np.float32))
        # the loop survives the failed batch
        np.testing.assert_allclose(pi.predict(np.ones((1, 2), np.float32)),
                                   net.output(np.ones((1, 2), np.float32)),
                                   rtol=1e-6)
        pi.stop()
    finally:
        faults.reset()


def test_wrapper_on_one_rank_is_the_network_step(caplog):
    """World 1: no collective, no context — exactly ``net.fit``'s step;
    the rules shard nothing on a mesh of one."""
    a, b = _port_small(), _port_small()
    _, _, batches = _inputs()["small"]
    for x, y in batches:
        a.fit(x, y, batch_size=x.shape[0])
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet

    pw = ParallelWrapper(b, mesh=make_mesh({"data": 1, "model": 1},
                                           device="cpu"),
                         tp_rules=DEFAULT_TP_RULES)
    with caplog.at_level(logging.WARNING):
        pw.fit([DataSet(x, y) for x, y in batches])
    np.testing.assert_array_equal(a.params_flat(), b.params_flat())
    assert b.iteration_count == len(batches)
    assert "none" in pw.lower_step_hlo(*batches[0])


def test_graph_requests_are_batched_where_the_jax_package_fails():
    """A ComputationGraph with a convolutional input: the JAX
    ``ParallelInference._req_ndim`` reads ``conf.input_type``, which a
    graph configuration does not have, so a batched image request is
    taken for one example and the forward fails (ROADMAP Queue 3, not a
    port fault). The port reads the graph's first input type."""
    from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
    from deeplearning4j_tpu.nn.graph import graph_builder
    from deeplearning4j_tpu.parallel import ParallelInference as JPI

    b = (graph_builder().seed(2).add_inputs("in")
         .set_input_types(**{"in": jnn.InputType.convolutional(8, 8, 3)}))
    b.add_layer("c", jnn.ConvolutionLayer(n_out=4, kernel=(3, 3),
                                          activation="relu"), "in")
    b.add_layer("p", jnn.GlobalPoolingLayer(), "c")
    b.add_layer("out", jnn.OutputLayer(n_out=3, activation="softmax",
                                       loss="mcxent"), "p")
    b.set_outputs("out")
    jnet = JGraph(b.build())
    jnet.init()
    x = np.random.RandomState(0).rand(2, 8, 8, 3).astype(np.float32)
    jpi = JPI(jnet).start()
    try:
        with pytest.raises(TypeError, match="ndim"):
            jpi.predict(x)
    finally:
        jpi.stop()
    tnet = tnn.ComputationGraph(
        tnn.ComputationGraphConfiguration.from_json(jnet.conf.to_json()),
        device="cpu").init(jax.tree.map(np.asarray, jnet.params))
    pi = ParallelInference(tnet).start()
    try:
        got = pi.predict(x)
    finally:
        pi.stop()
    np.testing.assert_allclose(got, np.asarray(jnet.output(x)[0]),
                               rtol=1e-5, atol=1e-6)


def test_generative_is_a_generative_engine():
    """``ParallelInference.generative``: the continuous-batching tier's
    engine over a decoder model, with the caller's engine arguments."""
    from deeplearning4j_tpu_torch.models.gpt import GptModel
    from deeplearning4j_tpu_torch.serving import GenerativeEngine
    from deeplearning4j_tpu_torch.testing.gpt_serving import tiny_config

    cfg = tiny_config()
    model = GptModel(cfg, seed=0, device="cpu")
    eng = ParallelInference.generative(model, max_slots=2, seed=3,
                                       device="cpu")
    assert isinstance(eng, GenerativeEngine)
    assert eng.scheduler.max_slots == 2
    r = eng.generate([np.arange(1, 6, dtype=np.int32)], max_new_tokens=3)
    assert r[0].tokens.size == 3
