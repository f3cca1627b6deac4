"""Checkpointed, supervised training of the PyTorch port (CPU).

Mirrors ``tests/test_preemption.py`` on the port: the async checkpoint
writer, retention, exact resume (a fit killed at any step and resumed
replays the uninterrupted run bit for bit, dropout included), the
cross-process resume, SIGTERM, the checkpoint listener, the graph's tBPTT
saving only at batch boundaries and SameDiff resume. Then the state
carried across packages: a checkpoint directory written by the JAX
package's ``TrainingCheckpointer(use_orbax=False)`` restores into the
port's same-configured network and the reverse, and both continue to the
JAX oracle's parameters within 1e-5 relative L2 (float32 steps of the two
frameworks sum in other orders).
"""

import json
import logging
import os
import signal
import threading
import time
import types

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import faults as jfaults
from deeplearning4j_tpu import nn as jnn
from deeplearning4j_tpu.parallel import (
    TrainingCheckpointer as JCheckpointer,
    TrainingSupervisor as JSupervisor)
from deeplearning4j_tpu_torch import faults, nn, observe
from deeplearning4j_tpu_torch.autodiff.samediff import (
    SameDiff, TrainingConfig)
from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.faults import InjectedFault
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph, graph_builder
from deeplearning4j_tpu_torch.nn.listeners import (
    CollectScoresIterationListener, TrainingListener)
from deeplearning4j_tpu_torch.parallel import (
    CheckpointTrainingListener, CheckpointWriteError, TrainingCheckpointer,
    TrainingSupervisor)
from deeplearning4j_tpu_torch.parallel.checkpoint import keystr_leaves

CROSS_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _clean_faults(monkeypatch):
    monkeypatch.delenv(faults.FAULTS_ENV, raising=False)
    faults.reset()
    jfaults.reset()
    yield
    faults.reset()
    jfaults.reset()


def mln_conf(pkg, seed=7, hidden=8, dropout=0.0):
    return (pkg.builder().seed(seed).updater(pkg.Adam(learning_rate=0.02))
            .weight_init("xavier").list()
            .layer(pkg.DenseLayer(n_out=hidden, activation="tanh",
                                  dropout=dropout))
            .layer(pkg.OutputLayer(n_out=2, activation="softmax",
                                   loss="mcxent"))
            .set_input_type(pkg.InputType.feed_forward(2)).build())


def build_mln(seed=7, dropout=0.5):
    """The JAX test's network, with dropout 0.5: the generator state is
    part of exact resume."""
    return nn.MultiLayerNetwork(mln_conf(nn, seed, dropout=dropout),
                                device="cpu").init()


def xy(n=64, seed=0):
    r = np.random.RandomState(seed)
    x = r.rand(n, 2).astype(np.float32)
    y = np.zeros((n, 2), np.float32)
    y[np.arange(n), r.randint(0, 2, n)] = 1.0
    return x, y


def fake_net(value: float, size=16):
    """A minimal state carrier whose parameters encode ``value``, so a
    torn or mixed restore shows in the content."""
    net = types.SimpleNamespace()
    net.params = {"W": np.full((size, size), value, np.float32)}
    net.opt_state = {"W": np.zeros((size, size), np.float32)}
    net.net_state = {}
    net.iteration_count = int(value)
    net.epoch_count = 0
    net.batch_in_epoch = 0
    return net


def new_shape_events():
    return sum(1 for e in observe.ledger().events()
               if e.cause == "new_shape")


def _flat_state(net):
    return (net.params_flat(), net.updater_state_flat(),
            net._gen.get_state().numpy())


# ---------------------------------------------------------------------------
# async writer
# ---------------------------------------------------------------------------
class TestAsyncWriter:
    def test_drop_oldest_keeps_newest(self, tmp_path):
        ck = TrainingCheckpointer(str(tmp_path), keep_last=None,
                                  max_queue=2)
        m = observe.metrics()
        dropped0 = m.counter("dl4j_tpu_ckpt_dropped_total").value
        for i in range(1, 13):
            ck.save_async(i, fake_net(float(i)))
        assert ck.wait_until_finished(timeout=60.0)
        assert ck.pending_async() == 0
        assert ck.latest_step() == 12
        assert m.counter("dl4j_tpu_ckpt_dropped_total").value > dropped0
        net = fake_net(0.0)
        assert ck.restore(net) == 12
        assert float(net.params["W"][0, 0]) == 12.0
        ck.close()

    def test_block_policy_writes_everything(self, tmp_path):
        ck = TrainingCheckpointer(str(tmp_path), keep_last=None,
                                  max_queue=1, overflow="block")
        m = observe.metrics()
        blocked0 = m.counter("dl4j_tpu_ckpt_blocked_total").value
        for i in range(1, 7):
            ck.save_async(i, fake_net(float(i)))
        assert ck.wait_until_finished(timeout=60.0)
        assert sorted(s for s, _, _ in ck._saved) == [1, 2, 3, 4, 5, 6]
        assert m.counter("dl4j_tpu_ckpt_blocked_total").value > blocked0
        ck.close()

    def test_invalid_overflow_policy_and_orbax(self, tmp_path):
        with pytest.raises(ValueError, match="overflow"):
            TrainingCheckpointer(str(tmp_path), overflow="shrug")
        with pytest.raises(ValueError, match="orbax is a JAX library"):
            TrainingCheckpointer(str(tmp_path), use_orbax=True)

    def test_writer_failure_surfaces_on_next_save(self, tmp_path):
        ck = TrainingCheckpointer(str(tmp_path))
        faults.arm("worker_death", prob=1.0, max_fires=1)
        ck.save_async(1, fake_net(1.0))
        ck.wait_until_finished(timeout=60.0)
        with pytest.raises(CheckpointWriteError, match="step"):
            ck.save_async(2, fake_net(2.0))
        ck.save_async(3, fake_net(3.0))  # the raise drained the failures
        assert ck.wait_until_finished(timeout=60.0)
        assert ck.latest_step() == 3
        # the dead write's .tmp was swept by the drain
        assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
        ck.close()

    def test_sync_save_also_surfaces_writer_failure(self, tmp_path):
        ck = TrainingCheckpointer(str(tmp_path))
        faults.arm("worker_death", prob=1.0, max_fires=1)
        ck.save_async(1, fake_net(1.0))
        ck.wait_until_finished(timeout=60.0)
        with pytest.raises(CheckpointWriteError):
            ck.save(2, fake_net(2.0))
        ck.close()

    def test_no_coalescing_without_backpressure(self, tmp_path):
        class SlowWrite(TrainingCheckpointer):
            def _write_npz(self, step, state):
                time.sleep(0.05)
                return super()._write_npz(step, state)

        ck = SlowWrite(str(tmp_path), keep_last=None, max_queue=8)
        for i in (1, 2, 3):
            ck.save_async(i, fake_net(float(i)))
            time.sleep(0.01)
        assert ck.wait_until_finished(timeout=60.0)
        assert sorted(s for s, _, _ in ck._saved) == [1, 2, 3]
        ck.close()

    def test_close_retires_writer_thread(self, tmp_path):
        ck = TrainingCheckpointer(str(tmp_path))
        ck.save_async(1, fake_net(1.0))
        ck.close(timeout=30.0)
        assert ck._writer._thread is None
        ck.save_async(2, fake_net(2.0))  # restarts the writer
        assert ck.wait_until_finished(timeout=30.0)
        assert ck.latest_step() == 2
        ck.close(timeout=30.0)

    def test_orphaned_tmp_swept_on_init(self, tmp_path):
        (tmp_path / "step_9.npz.tmp").write_bytes(b"partial")
        TrainingCheckpointer(str(tmp_path))
        assert not (tmp_path / "step_9.npz.tmp").exists()

    def test_restore_missing_explicit_step_raises_value_error(
            self, tmp_path):
        ck = TrainingCheckpointer(str(tmp_path))
        ck.save(1, fake_net(1.0))
        with pytest.raises(ValueError, match="no checkpoint recorded"):
            ck.restore(fake_net(0.0), step=99)

    def test_async_metrics_and_event(self, tmp_path, monkeypatch):
        log = tmp_path / "ev.jsonl"
        monkeypatch.setenv(observe.OBS_LOG_ENV, str(log))
        m = observe.metrics()
        saves0 = m.counter("dl4j_tpu_ckpt_async_saves_total").value
        ck = TrainingCheckpointer(str(tmp_path / "ck"))
        ck.save_async(1, fake_net(1.0))
        assert ck.wait_until_finished(timeout=60.0)
        assert m.counter("dl4j_tpu_ckpt_async_saves_total").value > saves0
        assert m.histogram("dl4j_tpu_ckpt_write_seconds").count > 0
        assert int(m.gauge("dl4j_tpu_ckpt_queue_depth").value) == 0
        assert '"kind": "ckpt_async"' in log.read_text()
        ck.close()


# ---------------------------------------------------------------------------
# the file: key paths, sha256, fallback
# ---------------------------------------------------------------------------
class TestFile:
    def test_keys_are_the_jax_packages(self, tmp_path):
        """The port's file holds the JAX package's key for every leaf
        (``jax.tree_util.keystr`` form), plus its generator state."""
        jnet = jnn.MultiLayerNetwork(mln_conf(jnn, dropout=0.5)).init()
        JCheckpointer(str(tmp_path / "j"), use_orbax=False).save(3, jnet)
        TrainingCheckpointer(str(tmp_path / "t")).save(3, build_mln())
        with np.load(tmp_path / "j" / "step_3.npz") as j, \
                np.load(tmp_path / "t" / "step_3.npz") as t:
            assert set(j.files) - {"['rng_key']"} == \
                set(t.files) - {"['torch_rng_state']"}
            for k in j.files:
                if k != "['rng_key']":
                    assert j[k].shape == t[k].shape and \
                        j[k].dtype == t[k].dtype, k

    def test_keystr_leaves_match_jax_tree_util(self):
        import jax

        tree = {"b": [np.zeros(1), (np.ones(2), None)], "a": {},
                "c": {"x": np.ones(1), "w": np.zeros(3)},
                "d": {1: np.ones(1), 0: np.ones(2)}}
        want = [(jax.tree_util.keystr(p), leaf) for p, leaf in
                jax.tree_util.tree_leaves_with_path(tree)]
        got = keystr_leaves(tree)
        assert [k for k, _ in got] == [k for k, _ in want] == [
            "['b'][0]", "['b'][1][0]", "['c']['w']", "['c']['x']",
            "['d'][0]", "['d'][1]"]
        assert all(a is b for (_, a), (_, b) in zip(got, want))

    def test_torn_newest_falls_back(self, tmp_path, monkeypatch):
        log = tmp_path / "ev.jsonl"
        monkeypatch.setenv(observe.OBS_LOG_ENV, str(log))
        m = observe.metrics()
        c0 = m.counter("dl4j_tpu_checkpoint_corrupt_total").value
        f0 = m.counter("dl4j_tpu_checkpoint_fallback_total").value
        ck = TrainingCheckpointer(str(tmp_path / "ck"), keep_last=None)
        ck.save(1, fake_net(1.0))
        faults.arm("checkpoint_torn_write", max_fires=1)
        ck.save(2, fake_net(2.0))
        net = fake_net(0.0)
        assert ck.restore(net) == 1
        assert float(net.params["W"][0, 0]) == 1.0
        assert m.counter("dl4j_tpu_checkpoint_corrupt_total").value == c0 + 1
        assert m.counter("dl4j_tpu_checkpoint_fallback_total").value == f0 + 1
        assert '"kind": "checkpoint_fallback"' in log.read_text()
        with pytest.raises(IOError, match="integrity"):
            ck.restore(fake_net(0.0), step=2)

    def test_bfloat16_leaves_round_trip(self, tmp_path):
        conf = (nn.builder().seed(1).dtype("bfloat16")
                .updater(nn.Adam(learning_rate=0.01)).list()
                .layer(nn.DenseLayer(n_out=4, activation="tanh"))
                .layer(nn.OutputLayer(n_out=2, activation="softmax",
                                      loss="mcxent"))
                .set_input_type(nn.InputType.feed_forward(3)).build())
        net = nn.MultiLayerNetwork(conf, device="cpu").init()
        x, y = np.ones((2, 3), np.float32), np.eye(2, dtype=np.float32)
        net.fit(x, y)
        ck = TrainingCheckpointer(str(tmp_path))
        ck.save(1, net)
        fresh = nn.MultiLayerNetwork(conf, device="cpu").init()
        assert ck.restore(fresh) == 1
        for a, b in zip(keystr_leaves(fresh.params + fresh.opt_state),
                        keystr_leaves(net.params + net.opt_state)):
            assert a[1].dtype == torch.bfloat16
            assert torch.equal(a[1], b[1])


# ---------------------------------------------------------------------------
# retention
# ---------------------------------------------------------------------------
class TestRetention:
    def test_keep_last_prunes_oldest(self, tmp_path):
        ck = TrainingCheckpointer(str(tmp_path), keep_last=2)
        for i in (1, 2, 3, 4):
            ck.save(i, fake_net(float(i)))
        assert [s for s, _, _ in ck._saved] == [3, 4]
        assert not os.path.exists(os.path.join(str(tmp_path), "step_1.npz"))

    def test_eviction_never_deletes_only_restorable(self, tmp_path):
        ck = TrainingCheckpointer(str(tmp_path), keep_last=2)
        ck.save(3, fake_net(3.0))
        faults.arm("checkpoint_torn_write", prob=1.0, max_fires=2)
        ck.save(4, fake_net(4.0))
        ck.save(5, fake_net(5.0))
        faults.reset()
        steps = sorted(s for s, _, _ in ck._saved)
        assert 3 in steps and len(steps) == 2
        net = fake_net(0.0)
        assert ck.restore(net) == 3
        assert float(net.params["W"][0, 0]) == 3.0

    def test_queued_async_writes_do_not_count_toward_keep_last(
            self, tmp_path):
        ck = TrainingCheckpointer(str(tmp_path), keep_last=2, max_queue=4)
        ck.save(1, fake_net(1.0))
        ck.save(2, fake_net(2.0))
        for i in (3, 4):
            ck.save_async(i, fake_net(float(i)))
        assert ck.wait_until_finished(timeout=60.0)
        steps = sorted(s for s, _, _ in ck._saved)
        assert len(steps) == 2 and steps[-1] == 4
        assert ck.restore(fake_net(0.0)) == 4
        ck.close()

    def test_old_marker_without_cursor_still_loads(self, tmp_path):
        ck = TrainingCheckpointer(str(tmp_path))
        state = ck._state_of(fake_net(5.0))
        state.pop("data_cursor")
        ck._write_and_record(5, state)
        ck2 = TrainingCheckpointer(str(tmp_path))
        target = fake_net(0.0)
        target.batch_in_epoch = 3
        assert ck2.restore(target) == 5
        assert target.batch_in_epoch == 3


# ---------------------------------------------------------------------------
# exact resume
# ---------------------------------------------------------------------------
class TestExactResume:
    @pytest.mark.parametrize("kill_at", [1, 3, 7, 11])
    def test_kill_at_every_k_bit_exact(self, tmp_path, kill_at):
        """The injected ``preemption`` fault kills the fit after
        ``kill_at`` steps; the supervised resume replays the oracle's
        per-step losses, final parameters, Adam state and dropout
        generator state bit for bit, with no ``new_shape`` event."""
        x, y = xy(64)
        oracle = build_mln()
        col_o = CollectScoresIterationListener()
        oracle.set_listeners(col_o)
        oracle.fit(x, y, epochs=3, batch_size=16)  # 4 batches x 3 epochs
        want = dict(col_o.scores)

        ns0 = new_shape_events()
        net = build_mln()
        col = CollectScoresIterationListener()
        net.set_listeners(col)
        ck = TrainingCheckpointer(str(tmp_path / f"k{kill_at}"))
        sup = TrainingSupervisor(net, ck, save_every=1, max_restarts=3,
                                 restart_backoff_s=0.0)
        faults.arm("preemption", prob=1.0, after_n=kill_at, max_fires=1)
        assert sup.fit(x, y, epochs=3, batch_size=16) == "completed"
        assert faults.fire_counts() == {"preemption": 1}
        assert sup.restarts == 1
        assert dict(col.scores) == want
        for a, b in zip(_flat_state(net), _flat_state(oracle)):
            np.testing.assert_array_equal(a, b)
        assert (net.iteration_count, net.epoch_count, net.batch_in_epoch) \
            == (12, 3, 0)
        assert new_shape_events() - ns0 == 0

    @pytest.mark.parametrize("donate", [False, True],
                             ids=["rebinding", "in_place"])
    def test_restore_keeps_the_tensors_in_place(self, tmp_path, monkeypatch,
                                                donate):
        """A restore copies the checkpoint into the network's own
        tensors (on the card, a captured training step's static
        buffers): every parameter, updater-state and layer-state tensor
        keeps its object and ``data_ptr``, holds the checkpoint's values,
        and the fit resumed from it equals the uninterrupted one bit for
        bit. ``in_place`` forces the card's donated step on the CPU."""
        from deeplearning4j_tpu_torch.nn import compiled, multilayer

        if donate:
            for mod in (compiled, multilayer):
                monkeypatch.setattr(mod, "donates", lambda device: True)
        x, y = xy(64)
        oracle = build_mln()
        oracle.fit(x, y, epochs=2, batch_size=16)
        net = build_mln()
        ck = TrainingCheckpointer(str(tmp_path))
        net.fit(x, y, epochs=1, batch_size=16)
        ck.save(net.iteration_count, net)
        saved = _flat_state(net)
        net.fit(x, y, epochs=1, batch_size=16)
        live = compiled.tensors_of(net.params, net.opt_state, net.net_state)
        ptrs = [t.data_ptr() for t in live]
        assert ck.restore(net) == 4
        after = compiled.tensors_of(net.params, net.opt_state, net.net_state)
        assert all(a is b for a, b in zip(after, live))
        assert [t.data_ptr() for t in after] == ptrs
        for a, b in zip(_flat_state(net), saved):
            np.testing.assert_array_equal(a, b)
        assert (net.iteration_count, net.epoch_count) == (4, 1)
        net.fit(x, y, epochs=1, batch_size=16)
        for a, b in zip(_flat_state(net), _flat_state(oracle)):
            np.testing.assert_array_equal(a, b)

    def test_resume_replays_from_an_older_checkpoint(self, tmp_path):
        """Saves every 4 steps, killed after 6: the resume replays steps
        5 and 6 from step 4 and still lands on the oracle."""
        x, y = xy(64)
        oracle = build_mln()
        oracle.fit(x, y, epochs=2, batch_size=16)
        net = build_mln()
        ck = TrainingCheckpointer(str(tmp_path))
        sup = TrainingSupervisor(net, ck, save_every=4,
                                 restart_backoff_s=0.0, asynchronous=False)
        faults.arm("preemption", after_n=6, max_fires=1)
        assert sup.fit(x, y, epochs=2, batch_size=16) == "completed"
        for a, b in zip(_flat_state(net), _flat_state(oracle)):
            np.testing.assert_array_equal(a, b)

    def test_shuffled_iterator_is_realigned(self, tmp_path):
        """A reshuffling iterator with a pre-processor: the resumed epoch
        sees the oracle's order (the supervisor realigns ``_epoch``)."""
        x, y = xy(64)

        def data():
            it = ListDataSetIterator(DataSet(x * 255.0, y), batch_size=16,
                                     shuffle=True, seed=11)
            from deeplearning4j_tpu_torch.datasets import (
                ImagePreProcessingScaler)
            it.set_pre_processor(ImagePreProcessingScaler())
            return it

        oracle = build_mln()
        oracle.fit(data(), epochs=3)
        net = build_mln()
        sup = TrainingSupervisor(net, TrainingCheckpointer(str(tmp_path)),
                                 save_every=1, restart_backoff_s=0.0)
        faults.arm("preemption", after_n=6, max_fires=1)
        assert sup.fit(data(), epochs=3) == "completed"
        np.testing.assert_array_equal(net.params_flat(), oracle.params_flat())

    def test_cross_process_resume(self, tmp_path):
        x, y = xy(64)
        oracle = build_mln()
        oracle.fit(x, y, epochs=2, batch_size=16)

        class PreemptAt(TrainingListener):
            def iteration_done(self, model, iteration, epoch, score):
                if iteration == 3:
                    faults.request_preemption()

        net = build_mln()
        net.set_listeners(PreemptAt())
        ck = TrainingCheckpointer(str(tmp_path))
        sup = TrainingSupervisor(net, ck, save_every=100)
        assert sup.fit(x, y, epochs=2, batch_size=16) == "preempted"
        assert ck.latest_step() == 3
        faults.clear_preemption()
        net2 = build_mln(seed=99)  # the restore must overwrite everything
        sup2 = TrainingSupervisor(net2, TrainingCheckpointer(str(tmp_path)),
                                  save_every=100)
        assert sup2.fit(x, y, epochs=2, batch_size=16) == "completed"
        for a, b in zip(_flat_state(net2), _flat_state(oracle)):
            np.testing.assert_array_equal(a, b)

    def test_resume_counts_and_event(self, tmp_path, monkeypatch):
        log = tmp_path / "ev.jsonl"
        monkeypatch.setenv(observe.OBS_LOG_ENV, str(log))
        m = observe.metrics()
        r0 = m.counter("dl4j_tpu_ckpt_resumes_total").value
        x, y = xy(32)
        sup = TrainingSupervisor(build_mln(),
                                 TrainingCheckpointer(str(tmp_path / "ck")),
                                 save_every=1, restart_backoff_s=0.0)
        faults.arm("preemption", prob=1.0, after_n=2, max_fires=1)
        assert sup.fit(x, y, epochs=2, batch_size=16) == "completed"
        assert m.counter("dl4j_tpu_ckpt_resumes_total").value == r0 + 1
        events = [json.loads(s) for s in log.read_text().splitlines()]
        kinds = [e["kind"] for e in events]
        assert "train_resume" in kinds and "fault_injected" in kinds
        # killed at the start of epoch 2, resumed from the step-2 save
        # (epoch 1's cursor at its end): the replayed epoch 1 trains no
        # batch, as in the JAX package
        assert [(e["epoch"], e["steps"]) for e in events
                if e["kind"] == "train_epoch"] == [(1, 2), (1, 0), (2, 2)]

    def test_restart_budget_exhausted_raises(self, tmp_path):
        x, y = xy(32)
        sup = TrainingSupervisor(build_mln(),
                                 TrainingCheckpointer(str(tmp_path)),
                                 save_every=1, max_restarts=2,
                                 restart_backoff_s=0.0)
        faults.arm("preemption", prob=1.0)  # every step, forever
        with pytest.raises(InjectedFault):
            sup.fit(x, y, epochs=2, batch_size=16)
        assert sup.restarts == 3

    def test_computation_graph_resume(self, tmp_path):
        x, y = xy(48)

        def build_cg(seed=5):
            conf = (graph_builder().seed(seed)
                    .updater(nn.Adam(learning_rate=0.02)).add_inputs("in")
                    .set_input_types(**{"in": nn.InputType.feed_forward(2)})
                    .add_layer("d", nn.DenseLayer(n_out=8, activation="tanh",
                                                  dropout=0.5), "in")
                    .add_layer("out", nn.OutputLayer(
                        n_out=2, activation="softmax", loss="mcxent"), "d")
                    .set_outputs("out").build())
            return ComputationGraph(conf, device="cpu").init()

        oracle = build_cg()
        oracle.fit(x, y, epochs=2, batch_size=16)
        net = build_cg()
        sup = TrainingSupervisor(net, TrainingCheckpointer(str(tmp_path)),
                                 save_every=1, restart_backoff_s=0.0)
        faults.arm("preemption", prob=1.0, after_n=3, max_fires=1)
        assert sup.fit(x, y, epochs=2, batch_size=16) == "completed"
        np.testing.assert_array_equal(net.params_flat(), oracle.params_flat())
        assert torch.equal(net._gen.get_state(), oracle._gen.get_state())

    def test_samediff_resume(self, tmp_path):
        x, y = xy(64)

        def build_sd():
            sd = SameDiff.create(device="cpu")
            xs = sd.placeholder("x", shape=(None, 2))
            labels = sd.placeholder("labels", shape=(None, 2))
            w = sd.var("w", np.full((2, 2), 0.1, np.float32))
            b = sd.var("b", np.zeros((2,), np.float32))
            logits = (xs.mmul(w) + b).rename("logits")
            sd.loss.softmax_cross_entropy(logits, labels).rename("loss")
            sd.set_training_config(TrainingConfig(
                updater=nn.Adam(learning_rate=0.05),
                data_set_feature_mapping=["x"],
                data_set_label_mapping=["labels"],
                loss_variables=["loss"]))
            return sd

        it = ListDataSetIterator(DataSet(x, y), batch_size=16)
        oracle = build_sd()
        oracle.fit(it, epochs=2)
        sd = build_sd()
        sup = TrainingSupervisor(sd, TrainingCheckpointer(str(tmp_path)),
                                 save_every=1, restart_backoff_s=0.0)
        faults.arm("preemption", prob=1.0, after_n=5, max_fires=1)
        assert sup.fit(it, epochs=2) == "completed"
        assert sup.restarts == 1
        for name in ("w", "b"):
            assert torch.equal(sd._arrays[name], oracle._arrays[name])
        assert sd.epoch_count == 2 and sd.batch_in_epoch == 0


# ---------------------------------------------------------------------------
# SIGTERM / graceful preemption
# ---------------------------------------------------------------------------
class TestSigterm:
    def test_sigterm_sets_flag_and_snapshots(self, tmp_path):
        x, y = xy(64)
        net = build_mln()

        class KillAt(TrainingListener):
            def iteration_done(self, model, iteration, epoch, score):
                if iteration == 2:
                    os.kill(os.getpid(), signal.SIGTERM)

        net.set_listeners(KillAt())
        ck = TrainingCheckpointer(str(tmp_path))
        sup = TrainingSupervisor(net, ck, save_every=100,
                                 install_sigterm=True)
        prev = signal.getsignal(signal.SIGTERM)
        try:
            assert sup.fit(x, y, epochs=3, batch_size=16) == "preempted"
        finally:
            signal.signal(signal.SIGTERM, prev)
        assert not faults.preemption_requested()
        assert ck.latest_step() == 2
        net2 = build_mln(seed=1)
        assert TrainingCheckpointer(str(tmp_path)).restore(net2) == 2
        assert net2.iteration_count == 2 and net2.batch_in_epoch == 2

    def test_handler_restored_after_fit(self, tmp_path):
        x, y = xy(32)
        sup = TrainingSupervisor(build_mln(),
                                 TrainingCheckpointer(str(tmp_path)),
                                 install_sigterm=True)
        prev = signal.getsignal(signal.SIGTERM)
        sup.fit(x, y, epochs=1, batch_size=16)
        assert signal.getsignal(signal.SIGTERM) == prev

    def test_handler_not_installed_off_the_main_thread(self, tmp_path):
        x, y = xy(32)
        sup = TrainingSupervisor(build_mln(),
                                 TrainingCheckpointer(str(tmp_path)),
                                 install_sigterm=True)
        prev = signal.getsignal(signal.SIGTERM)
        out = []
        t = threading.Thread(target=lambda: out.append(
            sup.fit(x, y, epochs=1, batch_size=16)))
        t.start()
        t.join(timeout=60)
        assert not t.is_alive() and out == ["completed"]
        assert signal.getsignal(signal.SIGTERM) == prev

    def test_preempt_metric_counted_in_every_fit_loop(self, tmp_path):
        m = observe.metrics()
        x, y = xy(32)

        class PreemptAt(TrainingListener):
            def iteration_done(self, model, iteration, epoch, score):
                faults.request_preemption()

        for net in (build_mln(), ComputationGraph(
                graph_builder().seed(1).add_inputs("in")
                .set_input_types(**{"in": nn.InputType.feed_forward(2)})
                .add_layer("out", nn.OutputLayer(
                    n_out=2, activation="softmax", loss="mcxent"), "in")
                .set_outputs("out").build(), device="cpu").init()):
            p0 = m.counter("dl4j_tpu_train_preemptions_total").value
            net.set_listeners(PreemptAt())
            net.fit(x, y, epochs=1, batch_size=16)
            faults.clear_preemption()
            assert m.counter("dl4j_tpu_train_preemptions_total").value \
                == p0 + 1
            assert net.iteration_count == 1


# ---------------------------------------------------------------------------
# threaded save/restore race
# ---------------------------------------------------------------------------
class TestThreadedRace:
    def test_concurrent_save_restore_invariants(self, tmp_path):
        ck = TrainingCheckpointer(str(tmp_path), keep_last=3, max_queue=2)
        stop = threading.Event()
        errors = []

        def saver():
            step = 0
            while not stop.is_set():
                step += 1
                try:
                    ck.save_async(step, fake_net(float(step)))
                except CheckpointWriteError as e:
                    errors.append(e)
                time.sleep(0.001)
            ck.wait_until_finished(timeout=60.0)

        def restorer():
            while not stop.is_set():
                net = fake_net(0.0)
                got = ck.restore(net)
                if got is not None:
                    if not (np.asarray(net.params["W"]) == float(got)).all():
                        errors.append(AssertionError(f"mixed restore {got}"))
                    if net.iteration_count != got:
                        errors.append(AssertionError(f"cursor at {got}"))
                time.sleep(0.002)

        ts, tr = threading.Thread(target=saver), threading.Thread(
            target=restorer)
        ts.start()
        tr.start()
        time.sleep(0.8)
        stop.set()
        ts.join(timeout=30)
        tr.join(timeout=30)
        assert not ts.is_alive() and not tr.is_alive()
        assert not errors, errors[:3]
        net = fake_net(0.0)
        got = TrainingCheckpointer(str(tmp_path)).restore(net)
        assert got is not None
        assert (np.asarray(net.params["W"]) == float(got)).all()
        ck.close()


# ---------------------------------------------------------------------------
# the listener
# ---------------------------------------------------------------------------
class TestCheckpointListener:
    def test_final_save_when_boundary_missed(self, tmp_path):
        x, y = xy(96)  # 6 batches of 16
        net = build_mln()
        ck = TrainingCheckpointer(str(tmp_path))
        net.set_listeners(CheckpointTrainingListener(ck,
                                                     every_n_iterations=4))
        net.fit(x, y, epochs=1, batch_size=16)
        assert ck.latest_step() == 6
        assert 4 in [s for s, _, _ in ck._saved]

    def test_no_duplicate_final_save_on_boundary(self, tmp_path):
        x, y = xy(64)
        net = build_mln()
        ck = TrainingCheckpointer(str(tmp_path))
        net.set_listeners(CheckpointTrainingListener(ck,
                                                     every_n_iterations=4))
        m = observe.metrics()
        saves0 = m.counter("dl4j_tpu_checkpoint_saves_total").value
        net.fit(x, y, epochs=1, batch_size=16)
        assert m.counter("dl4j_tpu_checkpoint_saves_total").value \
            == saves0 + 1

    def test_iteration_done_resilient_to_raise(self, tmp_path, caplog):
        class Exploding(TrainingCheckpointer):
            def save(self, step, net):
                raise IOError("disk on fire")

            def save_async(self, step, net):
                raise IOError("disk on fire")

        x, y = xy(64)
        net = build_mln()
        net.set_listeners(CheckpointTrainingListener(
            Exploding(str(tmp_path)), every_n_iterations=1))
        with caplog.at_level(
                logging.WARNING,
                logger="deeplearning4j_tpu_torch.parallel.checkpoint"):
            net.fit(x, y, epochs=2, batch_size=16)
        warns = [r for r in caplog.records
                 if "training continues WITHOUT durability" in r.message]
        assert len(warns) == 1
        assert net.iteration_count == 8

    def test_fit_done_compensates_failed_tail_write(self, tmp_path):
        x, y = xy(32)  # 2 batches of 16
        net = build_mln()
        ck = TrainingCheckpointer(str(tmp_path))
        net.set_listeners(CheckpointTrainingListener(
            ck, every_n_iterations=1, asynchronous=True))
        faults.arm("worker_death", prob=1.0, after_n=1, max_fires=1)
        net.fit(x, y, epochs=1, batch_size=16)
        faults.reset()
        assert ck.wait_until_finished(timeout=60.0)
        assert ck.latest_step() == 2
        assert ck.restore(build_mln(seed=1)) == 2

    def test_cg_tbptt_checkpoints_only_at_batch_boundary(self, tmp_path):
        r = np.random.RandomState(0)
        x = r.randn(4, 9, 3).astype(np.float32)
        y = np.eye(2)[r.randint(0, 2, (4, 9))].astype(np.float32)
        b = (graph_builder().seed(9).updater(nn.Sgd(learning_rate=0.05))
             .add_inputs("in")
             .set_input_types(**{"in": nn.InputType.recurrent(3, -1)}))
        b.add_layer("lstm", nn.LSTM(n_in=3, n_out=5, activation="tanh"),
                    "in")
        b.add_layer("out", nn.RnnOutputLayer(n_in=5, n_out=2,
                                             activation="softmax",
                                             loss="mcxent"), "lstm")
        b.set_outputs("out")
        conf = b.build()
        conf.backprop_type = "tbptt"
        conf.tbptt_fwd_length = 3
        conf.tbptt_back_length = 3
        net = ComputationGraph(conf, device="cpu").init()
        ck = TrainingCheckpointer(str(tmp_path), keep_last=None)
        col = CollectScoresIterationListener()
        net.set_listeners(CheckpointTrainingListener(
            ck, every_n_iterations=1), col)
        net.fit(x, y, epochs=1, batch_size=4)  # 1 batch, 3 segments
        assert len(col.scores) == 3  # score listeners fire per segment
        steps = [s for s, _, _ in ck._saved]
        assert steps == [3]
        fresh = ComputationGraph(conf, device="cpu").init()
        assert ck.restore(fresh) == 3
        assert fresh.batch_in_epoch == 1
        assert fresh.iteration_count == net.iteration_count == 3


# ---------------------------------------------------------------------------
# state carried across the packages
# ---------------------------------------------------------------------------
class _PreemptAt:
    """Asks for a graceful preemption at one iteration (either
    package)."""

    def __init__(self, pkg_faults, at):
        self.faults, self.at = pkg_faults, at

    def iteration_done(self, model, iteration, epoch, score):
        if iteration == self.at:
            self.faults.request_preemption()

    def on_epoch_start(self, model):
        pass

    def on_epoch_end(self, model):
        pass


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoint_carries_across_packages(tmp_path, direction):
    """A run preempted at step 5 of 12 in one package, its checkpoint
    directory restored into a fresh network of the other (drawn from
    another seed), continued to the end: the JAX oracle's parameters
    and Adam state within 1e-5 relative L2."""
    x, y = xy(64, seed=3)
    oracle = jnn.MultiLayerNetwork(mln_conf(jnn)).init()
    start = [{k: np.asarray(v) for k, v in layer.items()}
             for layer in oracle.params]
    oracle.fit(x, y, epochs=3, batch_size=16)
    if direction == "jax_to_port":
        first = jnn.MultiLayerNetwork(mln_conf(jnn)).init()
        first.set_listeners(_PreemptAt(jfaults, 5))
        first_sup = JSupervisor(first, JCheckpointer(str(tmp_path),
                                                     use_orbax=False),
                                save_every=100)
        assert first_sup.fit(x, y, epochs=3, batch_size=16) == "preempted"
        jfaults.clear_preemption()
        # the relaunch: a fresh network and checkpointer of the other kind
        second = nn.MultiLayerNetwork(mln_conf(nn, seed=99),
                                      device="cpu").init()
        second_sup = TrainingSupervisor(second,
                                        TrainingCheckpointer(str(tmp_path)),
                                        save_every=100)
    else:
        first = nn.MultiLayerNetwork(mln_conf(nn), device="cpu").init(
            params=start)
        first.set_listeners(_PreemptAt(faults, 5))
        first_sup = TrainingSupervisor(first,
                                       TrainingCheckpointer(str(tmp_path)),
                                       save_every=100)
        assert first_sup.fit(x, y, epochs=3, batch_size=16) == "preempted"
        faults.clear_preemption()
        second = jnn.MultiLayerNetwork(mln_conf(jnn, seed=99)).init()
        second_sup = JSupervisor(second, JCheckpointer(str(tmp_path),
                                                       use_orbax=False),
                                 save_every=100)
    assert second_sup.fit(x, y, epochs=3, batch_size=16) == "completed"
    assert second_sup.restarts == 0
    assert (second.iteration_count, second.epoch_count) == (12, 3)
    assert _rel(second.params_flat(), oracle.params_flat()) <= CROSS_RTOL
    assert _rel(np.asarray(second.updater_state_flat()),
                np.asarray(oracle.updater_state_flat())) <= CROSS_RTOL
