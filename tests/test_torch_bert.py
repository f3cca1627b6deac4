"""BERT training parity of the PyTorch port against the JAX package (CPU).

``BertConfig.tiny(dropout=0.0)`` (2 layers, hidden 64, 4 heads of 16, 46
parameter leaves), parameters drawn by the JAX ``init_bert_params`` and
carried across as numpy. Whole-model parity is at dropout 0: the FFN
dropout masks come from ``jax.random.bernoulli`` there and from a
``torch.Generator`` here, and cannot match. Attention dropout is held at
the op level (``tests/test_torch_attention.py``: the keep mask bit for
bit, the dropout forward and the backward against the Pallas kernels).
The port's ``wordpiece`` copy yields the JAX module's batches.

Tolerances, float32: 1e-5 on encoder outputs, logits and losses (the same
arithmetic in another order on O(1) values); gradients 1e-5 absolute
plus 1e-4 relative (sums over the batch of products of O(0.02) weights);
parameters and Adam state after one step 1e-6 absolute plus 1e-5
relative (Adam moves an element by about lr = 2e-5; the first moment is
0.1·g, the second 0.001·g²). bfloat16 (``dtype=bfloat16`` models, bf16
compute): one bf16 unit is 2^-8 relative; the two frameworks round at
other places (torch upcasts inside its CPU matmuls and reductions), so
outputs are held to 4 units (2^-6 relative, 2e-2 absolute on O(1)
values); gradients to 2^-4 of the leaf's largest gradient plus 1e-6
(each gradient passes a dozen bf16 roundings each way; ``bk``'s gradient
is zero in exact arithmetic — a softmax row is shift-invariant — so both
sides hold ~1e-7 of cancellation residue). Parameters after k steps: 2·k·lr plus one bf16 unit in the last
place of the parameter (at most 2^-7 of it: both sides round) — each Adam
step moves an element by about ±lr with its
gradient's sign whatever the gradient's size, and tiny bf16 gradients
may differ in sign between the frameworks (a leaf the loss no longer
reaches keeps moving on its first moment).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deeplearning4j_tpu.models import bert as jbert
from deeplearning4j_tpu.nlp import wordpiece as jwp
from deeplearning4j_tpu_torch.models import bert as tbert
from deeplearning4j_tpu_torch.models._tree import leaf_paths
from deeplearning4j_tpu_torch.nlp import wordpiece as twp

F32 = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-5)
STEP = dict(rtol=1e-5, atol=1e-6)
BF16 = dict(rtol=2.0 ** -6, atol=2e-2)
LR = 2e-5

CFG_J = jbert.BertConfig.tiny(dropout=0.0)
CFG_T = tbert.BertConfig.tiny(dropout=0.0)


def _batch(n=4, t=16, seed=0, vocab=256):
    """A BertIterator-layout batch: [CLS] … [SEP] then padding, ragged."""
    r = np.random.RandomState(seed)
    lens = np.array([t, t // 2, 5, t - 3])[:n]
    ids = r.randint(5, vocab, (n, t)).astype(np.int32)
    ids[:, 0] = 2
    ids[np.arange(n), lens - 1] = 3
    mask = (np.arange(t)[None, :] < lens[:, None]).astype(np.int32)
    ids = ids * mask
    sel = (r.rand(n, t) < 0.15) & (mask > 0)
    sel[:, 0] = False
    sel[0, 1] = True  # at least one masked position
    return {"ids": ids, "segments": np.zeros_like(ids), "mask": mask,
            "labels": np.eye(2, dtype=np.float32)[r.randint(0, 2, n)],
            "mlm_labels": np.where(sel, ids, 0).astype(np.int32),
            "mlm_mask": sel.astype(np.float32)}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _torch_batch(batch):
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.asarray(v))
        out[k] = t.long() if k in ("ids", "segments", "mlm_labels") else t
    return out


def _f32(a):
    a = np.asarray(a)
    return a.astype(np.float32)


@pytest.fixture(scope="module")
def jax_params():
    """The JAX init of the tiny config, per dtype name."""
    return {name: jbert.init_bert_params(jax.random.key(0), CFG_J,
                                         dtype=getattr(jnp, name))
            for name in ("float32", "bfloat16")}


class TestWordPiece:
    CORPUS = ["the quick brown fox jumps over the lazy dog",
              "a stitch in time saves nine", "pack my box with five dozen",
              "liquor jugs and sphinx of black quartz judge my vow",
              "how vexingly quick daft zebras jump", "the five boxing wizards",
              "jump quickly", "unknown wordsxyz appear here"]

    def test_vocab_and_tokens_equal(self):
        assert twp.build_vocab(self.CORPUS) == jwp.build_vocab(self.CORPUS)
        vocab = jwp.build_vocab(self.CORPUS[:5], max_size=60)
        ja, to = (jwp.BertWordPieceTokenizer(vocab),
                  twp.BertWordPieceTokenizer(vocab))
        for s in self.CORPUS:
            assert to.tokenize(s) == ja.tokenize(s)
            assert to.encode(s) == ja.encode(s)
            assert to.decode(to.encode(s)) == ja.decode(ja.encode(s))

    @pytest.mark.parametrize("task", ["seq_classification", "unsupervised"])
    def test_iterator_batches_equal(self, task):
        """Array for array, two epochs (the epoch advances the seed)."""
        vocab = jwp.build_vocab(self.CORPUS)
        labels = [i % 2 for i in range(len(self.CORPUS))]
        kw = dict(labels=labels, max_len=12, batch_size=3, task=task,
                  seed=7)
        ji = jwp.BertIterator(jwp.BertWordPieceTokenizer(vocab),
                              self.CORPUS, **kw)
        ti = twp.BertIterator(twp.BertWordPieceTokenizer(vocab),
                              self.CORPUS, **kw)
        for _ in range(2):
            jb, tb = list(ji), list(ti)
            assert len(jb) == len(tb) == 3
            for a, b in zip(jb, tb):
                assert a.keys() == b.keys()
                for k in a:
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)
                    assert a[k].dtype == b[k].dtype


class TestForwardParity:
    def test_param_tree_matches_jax(self, jax_params):
        shapes = tbert.param_shapes(CFG_T)
        j = [(p, tuple(a.shape)) for p, a in
             leaf_paths(_np_tree(jax_params["float32"]))]
        assert [(p, tuple(s)) for p, s in leaf_paths(shapes)] == j
        assert len(j) == 46
        base = tbert.param_shapes(tbert.BertConfig.base())
        sizes = [int(np.prod(s)) for _, s in leaf_paths(base)]
        assert (len(sizes), sum(sizes)) == (206, 110106428)
        params = tbert.init_bert_params(CFG_T, seed=3, device="cpu")
        for (path, s), (_, t) in zip(leaf_paths(shapes),
                                     leaf_paths(params)):
            assert tuple(t.shape) == tuple(s), path
        assert float(params["embeddings"]["word"].std()) == pytest.approx(
            0.02, rel=0.05)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_encoder_and_heads_match_jax(self, jax_params, dtype):
        tol = F32 if dtype == "float32" else BF16
        jp = jax_params[dtype]
        b = _batch()
        tp = tbert.bert_params_from_numpy(_np_tree(jp), device="cpu")
        assert tp["embeddings"]["word"].dtype == getattr(torch, dtype)
        tb = _torch_batch(b)
        args_j = (jnp.asarray(b["ids"]), jnp.asarray(b["segments"]),
                  jnp.asarray(b["mask"]))
        args_t = (tb["ids"], tb["segments"], tb["mask"])
        seq_j, pooled_j = jbert.bert_encoder(jp, *args_j, CFG_J)
        seq_t, pooled_t = tbert.bert_encoder(tp, *args_t, CFG_T)
        np.testing.assert_allclose(seq_t.float().numpy(), _f32(seq_j), **tol)
        np.testing.assert_allclose(pooled_t.float().numpy(), _f32(pooled_j),
                                   **tol)
        for jf, tf in ((jbert.classification_logits,
                        tbert.classification_logits),
                       (jbert.mlm_logits, tbert.mlm_logits)):
            np.testing.assert_allclose(
                tf(tp, *args_t, CFG_T).float().numpy(),
                _f32(jf(jp, *args_j, CFG_J)), **tol)


def _jax_loss(kind, cfg, batch):
    ids, seg, mask = (jnp.asarray(batch[k]) for k in
                      ("ids", "segments", "mask"))

    def loss_of(p):
        if kind == "cls":
            logits = jbert.classification_logits(p, ids, seg, mask, cfg,
                                                 train=True)
            logp = jax.nn.log_softmax(logits)
            return -jnp.mean(jnp.sum(jnp.asarray(batch["labels"]) * logp,
                                     axis=-1))
        logits = jbert.mlm_logits(p, ids, seg, mask, cfg, train=True)
        logp = jax.nn.log_softmax(logits)
        nll = -jnp.take_along_axis(
            logp, jnp.asarray(batch["mlm_labels"])[..., None], axis=-1)[..., 0]
        mm = jnp.asarray(batch["mlm_mask"])
        return jnp.sum(nll * mm) / jnp.maximum(jnp.sum(mm), 1.0)

    return loss_of


class TestGradientParity:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("kind", ["cls", "mlm"])
    def test_loss_and_all_leaf_gradients(self, jax_params, kind, dtype):
        """Every one of the 46 leaves, the unreached head (zeros) too."""
        b = _batch(seed=1)
        jp = jax_params[dtype]
        loss_j, grads_j = jax.value_and_grad(_jax_loss(kind, CFG_J, b))(jp)
        tp = tbert.bert_params_from_numpy(_np_tree(jp), device="cpu")
        paths = [p for p, _ in leaf_paths(tp)]
        leaves = [t.requires_grad_(True) for _, t in leaf_paths(tp)]
        fn = tbert.classification_loss if kind == "cls" else tbert.mlm_loss
        loss_t = fn(tp, _torch_batch(b), CFG_T)
        grads_t = torch.autograd.grad(loss_t, leaves, allow_unused=True)
        np.testing.assert_allclose(loss_t.item(), float(loss_j),
                                   **(F32 if dtype == "float32" else BF16))
        flat_j = [_f32(g) for _, g in leaf_paths(_np_tree(grads_j))]
        assert len(flat_j) == len(grads_t) == 46
        unreached = 0
        for path, gt, gj in zip(paths, grads_t, flat_j):
            if gt is None:
                unreached += 1
                assert not np.any(gj), path
                continue
            if dtype == "float32":
                np.testing.assert_allclose(gt.numpy(), gj, **GRAD,
                                           err_msg=str(path))
            else:
                err = np.abs(gt.float().numpy() - gj).max()
                assert err <= 2.0 ** -4 * np.abs(gj).max() + 1e-6, (path,
                                                                    err)
        # the head the loss does not reach: the MLM head (5 leaves) under
        # the classifier loss; pooler + classifier (4) under the MLM loss
        assert unreached == (5 if kind == "cls" else 4)


def _models(dtype_j, dtype_t):
    jm = jbert.BertModel(CFG_J, seed=0, dtype=dtype_j)
    tm = tbert.BertModel(CFG_T, seed=0, dtype=dtype_t, device="cpu")
    tm.params = tbert.bert_params_from_numpy(_np_tree(jm.params), "cpu")
    tm.opt_state = tbert.bert_opt_state_from_numpy(_np_tree(jm.opt_state),
                                                   "cpu")
    return jm, tm


def _assert_trees(t_tree, j_tree, tol, what):
    flat_t = list(leaf_paths(t_tree))
    flat_j = list(leaf_paths(_np_tree(j_tree)))
    assert [p for p, _ in flat_t] == [p for p, _ in flat_j]
    for (path, t), (_, j) in zip(flat_t, flat_j):
        np.testing.assert_allclose(t.float().numpy(), _f32(j), **tol,
                                   err_msg=f"{what} {path}")


class TestTrainStepParity:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_fit_classifier_then_fit_mlm(self, dtype):
        """One ``fit_classifier`` step, then one ``fit_mlm`` step, on
        batches with padding: losses, parameters and Adam state after
        each against the JAX ``BertModel``'s."""
        jm, tm = _models(getattr(jnp, dtype), getattr(torch, dtype))
        b1, b2 = _batch(seed=2), _batch(seed=3)
        for k, (fit, b) in enumerate((("fit_classifier", b1),
                                      ("fit_mlm", b2)), start=1):
            before = tbert.map_tree(lambda t: t.float().clone(), tm.params)
            loss_j = getattr(jm, fit)([b])
            loss_t = getattr(tm, fit)([b])
            if dtype == "float32":
                np.testing.assert_allclose(loss_t, loss_j, **F32)
                _assert_trees(tm.params, jm.params, STEP, f"{fit} params")
                _assert_trees(tm.opt_state, jm.opt_state, STEP,
                              f"{fit} adam")
            else:
                np.testing.assert_allclose(loss_t, loss_j, **BF16)
                for (path, t), (_, j), (_, t0) in zip(
                        leaf_paths(tm.params), leaf_paths(_np_tree(
                            jm.params)), leaf_paths(before)):
                    # k Adam steps of either sign, one bf16 unit
                    move = 2 * k * LR * 1.01
                    lim = move + 2.0 ** -7 * (np.abs(t0.numpy()) + move)
                    err = np.abs(t.float().numpy() - _f32(j))
                    assert np.all(err <= lim), (fit, path, err.max())
            assert tm.step == jm.step
        assert len(list(leaf_paths(tm.opt_state))) == 2 * 46

    def test_unreached_leaves_still_step(self):
        """Under ``fit_classifier`` the MLM head gets a zero gradient and
        still takes its Adam step (its state advances), as in JAX."""
        _, tm = _models(jnp.float32, torch.float32)
        tm.fit_classifier([_batch(seed=4)])
        assert tm.step == 1
        m = tm.opt_state["mlm"]["W"]["m"]
        assert not torch.any(m)  # 0.9·0 + 0.1·0
        assert torch.any(tm.opt_state["pooler"]["W"]["m"])

    def test_dropout_runs_are_reproducible_on_cpu(self):
        """At dropout 0.1 (generic attention dropout and FFN dropout from
        the model's generators), two models seeded alike train alike, and
        predict() (no dropout) is deterministic."""
        cfg = tbert.BertConfig.tiny()
        b = _batch(seed=5)
        runs = []
        for _ in range(2):
            m = tbert.BertModel(cfg, seed=9, device="cpu")
            runs.append((m.fit_classifier([b, b]), m.fit_mlm_scanned(b, 2),
                         m.predict(b["ids"], b["segments"], b["mask"])))
        assert runs[0][0] == runs[1][0]
        np.testing.assert_array_equal(runs[0][1], runs[1][1])
        np.testing.assert_array_equal(runs[0][2], runs[1][2])
        assert runs[0][2].shape == (4, 2) and runs[0][2].dtype == np.float32


class TestDeviceDefaults:
    def test_entry_points_default_to_cuda(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="is_available"):
            tbert.BertModel(CFG_T)
        with pytest.raises(RuntimeError, match="is_available"):
            tbert.init_bert_params(CFG_T)
        with pytest.raises(RuntimeError, match="is_available"):
            tbert.bert_params_from_numpy({"w": np.zeros(2, np.float32)})
        m = tbert.BertModel(CFG_T, device="cpu")
        assert m.params["embeddings"]["word"].device.type == "cpu"
