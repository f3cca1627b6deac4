"""BERT — fine-tuning and masked-LM training (PyTorch).

Counterpart of ``deeplearning4j_tpu/models/bert.py``: the same parameter
tree and names (the standard BERT checkpoint layout), the same post-LN
encoder, classification and tied-embedding MLM heads, and the same
training entry points — ``BertModel(cfg, seed=…)`` → ``fit_classifier`` /
``fit_mlm`` → ``predict``. Attention goes through the op registry's
``dot_product_attention``, so on the card it runs the flash kernels with
in-kernel attention dropout, forward and backward
(``ops/cuda_attention.py``); the parameter leaves step through
``Updater.apply_fused_many`` (the fused updater kernel, one multi-tensor
launch a step).

What differs from the JAX package:

* A step is the forward, ``torch.autograd.grad`` over the 206 leaves and
  one update of them all under ``no_grad``, run as a training unit
  (``nn/compiled.py``) keyed ``cls`` / ``mlm`` — the counterpart of the JAX
  package's jitted ``_cls_step`` / ``_mlm_step``: on the card one CUDA-graph
  capture per batch signature, replayed after, writing the parameters,
  the Adam state and the device iteration in place (the donated buffers);
  eager on the CPU (out of place there, as JAX returns new arrays) and
  under ``disable_capture()``. ``fit_mlm_scanned`` replays the ``mlm``
  unit once a step on the one batch, copies each loss into a device
  vector and reads it back once: no host read between steps, as the JAX
  package's ``lax.scan``.
* Randomness comes from ``torch.Generator``s, so the draws differ from
  ``jax.random``'s. The model keeps two device generators: one for
  attention dropout (one int32 kernel seed per layer and step on the flash
  path) and one for the FFN dropout masks, so two runs seeded alike draw
  the same FFN masks whichever attention path runs. Parity tests carry
  parameters across with :func:`bert_params_from_numpy` /
  :func:`bert_opt_state_from_numpy` and compare at dropout 0.
* A BERT imported from TF or ONNX is a SameDiff graph
  (``imports.import_frozen_graph``, ``imports.import_onnx``), not a
  ``BertModel``: the JAX package names a ``from_samediff_import`` in its
  docstring but defines none, and the port adds none.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch import observe
from deeplearning4j_tpu_torch.environment import resolve_device
from deeplearning4j_tpu_torch.models._tree import (
    leaf_paths, map_tree, params_from_numpy, rebuild,
)
from deeplearning4j_tpu_torch.models.gpt import _layer_norm
from deeplearning4j_tpu_torch.nn.compiled import (
    TrainUnits, donates, tensors_of)
from deeplearning4j_tpu_torch.nn.dtype import host_array, precision_scope
from deeplearning4j_tpu_torch.nn.updater import Adam, get_updater
from deeplearning4j_tpu_torch.ops.nn_ops import table_rows

# (attention-dropout generator, FFN-dropout generator)
DropoutRng = Tuple[torch.Generator, torch.Generator]


@dataclasses.dataclass(frozen=True)
class BertConfig:
    """BERT-base defaults."""

    vocab_size: int = 30522
    hidden: int = 768
    layers: int = 12
    heads: int = 12
    intermediate: int = 3072
    max_position: int = 512
    type_vocab: int = 2
    dropout: float = 0.1
    layer_norm_eps: float = 1e-12
    num_labels: int = 2  # classification head

    @staticmethod
    def base(**kw) -> "BertConfig":
        return BertConfig(**kw)

    @staticmethod
    def tiny(**kw) -> "BertConfig":
        """Test-sized config."""
        d = dict(vocab_size=256, hidden=64, layers=2, heads=4,
                 intermediate=128, max_position=128)
        d.update(kw)
        return BertConfig(**d)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def param_shapes(cfg: BertConfig) -> Dict[str, Any]:
    """The parameter tree with a shape at every leaf — the structure of the
    JAX ``init_bert_params`` pytree (12 layers: 206 leaves)."""
    e, f = cfg.hidden, cfg.intermediate
    layer = {
        "attn": {"Wq": (e, e), "bq": (e,), "Wk": (e, e), "bk": (e,),
                 "Wv": (e, e), "bv": (e,), "Wo": (e, e), "bo": (e,),
                 "ln_gamma": (e,), "ln_beta": (e,)},
        "ffn": {"W1": (e, f), "b1": (f,), "W2": (f, e), "b2": (e,),
                "ln_gamma": (e,), "ln_beta": (e,)},
    }
    return {
        "embeddings": {"word": (cfg.vocab_size, e),
                       "position": (cfg.max_position, e),
                       "token_type": (cfg.type_vocab, e),
                       "ln_gamma": (e,), "ln_beta": (e,)},
        "encoder": [layer for _ in range(cfg.layers)],
        "pooler": {"W": (e, e), "b": (e,)},
        "classifier": {"W": (e, cfg.num_labels), "b": (cfg.num_labels,)},
        "mlm": {"W": (e, e), "b": (e,), "ln_gamma": (e,), "ln_beta": (e,),
                "bias": (cfg.vocab_size,)},
    }


def init_bert_params(cfg: BertConfig, seed: int = 0,
                     dtype: torch.dtype = torch.float32,
                     device: Union[str, torch.device, None] = None
                     ) -> Dict[str, Any]:
    """Random parameters, the JAX init's scheme: N(0, 0.02) embeddings and
    matrices, zero biases, unit LayerNorm gains — drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device`` (``"cuda"``
    unless the caller passes ``"cpu"``). The streams differ from
    ``jax.random``'s; parity tests carry JAX parameters across with
    :func:`bert_params_from_numpy` instead."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def make(path, shape):
        name = path[-1]
        if name == "ln_gamma":
            return torch.ones(shape, dtype=dtype, device=dev)
        if name.startswith("W") or name in ("word", "position",
                                            "token_type"):
            return (0.02 * torch.randn(shape, generator=gen, device=dev)
                    ).to(dtype)
        return torch.zeros(shape, dtype=dtype, device=dev)

    shapes = param_shapes(cfg)
    return rebuild(shapes, {p: make(p, s) for p, s in leaf_paths(shapes)})


def bert_params_from_numpy(tree, device: Union[str, torch.device, None] = None,
                           dtype: Optional[torch.dtype] = None
                           ) -> Dict[str, Any]:
    """The JAX ``BertModel.params`` as numpy (``jax.tree.map(np.asarray,
    params)``) as the port's parameter tree on ``device``."""
    return params_from_numpy(tree, device, dtype)


def bert_opt_state_from_numpy(tree,
                              device: Union[str, torch.device, None] = None
                              ) -> Dict[str, Any]:
    """The JAX ``BertModel.opt_state`` as numpy (the parameter tree with an
    ``{"m": …, "v": …}`` dict at every leaf for Adam) as the port's
    updater state on ``device``."""
    return params_from_numpy(tree, device)


def _get(tree, path: tuple):
    for key in path:
        tree = tree[key]
    return tree


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------


def _attention(p, x, attn_mask, cfg: BertConfig, *, train: bool,
               rng: Optional[torch.Generator]):
    from deeplearning4j_tpu_torch.ops import exec_op

    n, t, d = x.shape
    h, dh = cfg.heads, cfg.hidden // cfg.heads

    def split(a):  # (N, T, E) -> (N, H, T, Dh): folds to N·H batch-major
        return a.reshape(n, t, h, dh).permute(0, 2, 1, 3)

    q = split(x @ p["Wq"] + p["bq"])
    k = split(x @ p["Wk"] + p["bk"])
    v = split(x @ p["Wv"] + p["bv"])
    drop = cfg.dropout if (train and cfg.dropout > 0 and rng is not None) \
        else 0.0
    m = None if attn_mask is None else attn_mask[:, None, None, :]
    out = exec_op("dot_product_attention", q, k, v, m, scaled=True,
                  dropout_rate=drop, dropout_rng=rng if drop > 0 else None)
    out = out.permute(0, 2, 1, 3).reshape(n, t, d)
    return out @ p["Wo"] + p["bo"]


def _type_rows(segments, table):
    """The token-type rows of ``segments``: ``nn_ops.table_rows``, whose
    gradient into the table of ``type_vocab`` (2) rows is a GEMM against
    the one-hot segments — the same bits every run, where
    ``F.embedding``'s backward on the card sums the batch's thousands of
    duplicate indices into those two rows in an order that varies."""
    return table_rows(table, segments)


def bert_encoder(params, ids, segments, mask, cfg: BertConfig, *,
                 train: bool = False, rng: Optional[DropoutRng] = None):
    """(N, T) integer ids → ``(N, T, H)`` sequence output and ``(N, H)``
    pooled [CLS]. ``mask``: (N, T), 1 = real token. ``rng``: the
    (attention, FFN) dropout generators; dropout runs only when ``train``
    and ``rng`` are given. Runs under the dtype policy's precision scope
    (the word embedding's dtype), as the JAX encoder does."""
    emb = params["embeddings"]
    policy = str(emb["word"].dtype).replace("torch.", "")
    attn_rng, ffn_rng = rng if rng is not None else (None, None)
    with precision_scope(policy):
        t = ids.shape[1]
        x = (F.embedding(ids, emb["word"]) + emb["position"][:t][None]
             + _type_rows(segments, emb["token_type"]))
        x = _layer_norm(x, emb["ln_gamma"], emb["ln_beta"],
                        cfg.layer_norm_eps)
        for blk in params["encoder"]:
            a = _attention(blk["attn"], x, mask, cfg, train=train,
                           rng=attn_rng)
            x = _layer_norm(x + a, blk["attn"]["ln_gamma"],
                            blk["attn"]["ln_beta"], cfg.layer_norm_eps)
            f = blk["ffn"]
            # jax.nn.gelu defaults to the tanh approximation
            hdn = F.gelu(x @ f["W1"] + f["b1"], approximate="tanh")
            if train and cfg.dropout > 0 and ffn_rng is not None:
                keep = torch.rand(hdn.shape, generator=ffn_rng,
                                  device=hdn.device) >= cfg.dropout
                hdn = torch.where(keep, hdn / (1 - cfg.dropout),
                                  torch.zeros_like(hdn))
            x = _layer_norm(x + hdn @ f["W2"] + f["b2"], f["ln_gamma"],
                            f["ln_beta"], cfg.layer_norm_eps)
        pooled = torch.tanh(x[:, 0] @ params["pooler"]["W"]
                            + params["pooler"]["b"])
    return x, pooled


def classification_logits(params, ids, segments, mask, cfg: BertConfig, *,
                          train: bool = False,
                          rng: Optional[DropoutRng] = None):
    _, pooled = bert_encoder(params, ids, segments, mask, cfg, train=train,
                             rng=rng)
    return pooled @ params["classifier"]["W"] + params["classifier"]["b"]


def mlm_logits(params, ids, segments, mask, cfg: BertConfig, *,
               train: bool = False, rng: Optional[DropoutRng] = None):
    seq, _ = bert_encoder(params, ids, segments, mask, cfg, train=train,
                          rng=rng)
    m = params["mlm"]
    h = F.gelu(seq @ m["W"] + m["b"], approximate="tanh")
    h = _layer_norm(h, m["ln_gamma"], m["ln_beta"], cfg.layer_norm_eps)
    return h @ params["embeddings"]["word"].T + m["bias"]  # tied embeddings


def classification_loss(params, batch, cfg: BertConfig, *, train=True,
                        rng: Optional[DropoutRng] = None):
    """Mean cross-entropy of the one-hot ``labels`` (the JAX
    ``_cls_step`` loss)."""
    logits = classification_logits(params, batch["ids"], batch["segments"],
                                   batch["mask"], cfg, train=train, rng=rng)
    logp = F.log_softmax(logits, dim=-1)
    return -torch.mean(torch.sum(batch["labels"] * logp, dim=-1))


def mlm_loss(params, batch, cfg: BertConfig, *, train=True,
             rng: Optional[DropoutRng] = None):
    """Mean negative log-likelihood over the masked positions (the JAX
    ``_mlm_step`` loss)."""
    logits = mlm_logits(params, batch["ids"], batch["segments"],
                        batch["mask"], cfg, train=train, rng=rng)
    logp = F.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, batch["mlm_labels"][..., None])[..., 0]
    mm = batch["mlm_mask"]
    return torch.sum(nll * mm) / torch.clamp(torch.sum(mm), min=1.0)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

# the training units' keys, the JAX package's jitted steps' names
_STEP_KEYS = {classification_loss: "cls", mlm_loss: "mlm"}

_INT_KEYS = ("ids", "segments", "mlm_labels")  # index tensors: int64
_MLM_KEYS = ("ids", "segments", "mask", "mlm_labels", "mlm_mask")


class BertModel:
    """Fine-tunable BERT: parameters, Adam state (lr 2e-5 by default, as in
    the JAX package) and the dropout generators, on ``device`` (``"cuda"``
    unless the caller passes ``"cpu"``)."""

    def __init__(self, cfg: BertConfig, seed: int = 0, updater=None,
                 dtype: torch.dtype = torch.float32,
                 device: Union[str, torch.device, None] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.updater = get_updater(updater) if updater is not None else Adam(
            learning_rate=2e-5)
        self.params = init_bert_params(cfg, seed, dtype, self.device)
        self.opt_state = map_tree(self.updater.init_state, self.params)
        self.step = 0
        self.rng: DropoutRng = (
            torch.Generator(device=self.device).manual_seed(seed + 1),
            torch.Generator(device=self.device).manual_seed(seed + 2))
        # the compiled steps (keys cls / mlm) and the device iteration
        self._steps = TrainUnits(self.device, "bert", self.rng)

    def num_params(self) -> int:
        return sum(t.numel() for _, t in leaf_paths(self.params))

    def _batch(self, batch, keys) -> Dict[str, torch.Tensor]:
        """The batch's arrays (numpy, or tensors already staged) on the
        model's device, the index arrays as int64."""
        out = {}
        for k in keys:
            v = batch[k]
            t = (v.to(self.device) if isinstance(v, torch.Tensor)
                 else torch.as_tensor(np.asarray(v), device=self.device))
            out[k] = t.long() if k in _INT_KEYS else t
        return out

    def _step(self, loss_fn, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The step's body: the loss, its gradient over every leaf (zeros
        for a leaf the loss does not reach, as ``jax.value_and_grad``
        gives), the updater's fused step over every leaf under
        ``no_grad`` (one multi-tensor launch on the card) at the device
        iteration, which it then advances. Returns the loss."""
        paths = [p for p, _ in leaf_paths(self.params)]
        leaves = [_get(self.params, p).detach().requires_grad_(True)
                  for p in paths]
        params = rebuild(self.params, dict(zip(paths, leaves)))
        loss = loss_fn(params, batch, self.cfg, train=True, rng=self.rng)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        step = self._steps.iteration.tensor
        donate = donates(self.device)
        lr = self.updater.lr(step)
        with torch.no_grad():
            ps = [p.detach() for p in leaves]
            gs = [torch.zeros_like(p) if g is None else g
                  for p, g in zip(ps, grads)]
            new_ps, new_ss = self.updater.apply_fused_many(
                ps, gs, [_get(self.opt_state, path) for path in paths], lr,
                step, inplace=donate)
            if not donate:
                self.params = rebuild(self.params, {
                    path: np_.to(p.dtype)
                    for path, p, np_ in zip(paths, ps, new_ps)})
                self.opt_state = rebuild(self.params,
                                         dict(zip(paths, new_ss)))
            step.add_(1)
        return loss.detach()

    def _donated(self) -> list:
        """The tensors a training step writes in place: parameters,
        updater state and the device iteration."""
        return tensors_of(self.params, self.opt_state) + [
            self._steps.iteration.tensor]

    def train_step(self, loss_fn, batch: Dict[str, torch.Tensor]
                   ) -> torch.Tensor:
        """One step as the training unit ``cls`` (the classification
        loss) or ``mlm`` (the masked-LM loss): returns the loss, a device
        scalar."""
        key = _STEP_KEYS.get(loss_fn, getattr(loss_fn, "__name__", "step"))
        names = tuple(sorted(batch))
        self._steps.iteration.at(self.step)
        loss = self._steps.run(
            key, lambda *t: self._step(loss_fn, dict(zip(names, t))),
            [batch[k] for k in names], layout=(names, self.cfg),
            state=self._donated(), signature=observe.signature_of(**batch))
        self._steps.iteration.advanced()
        self.step += 1
        return loss

    def _fit(self, loss_fn, keys, iterator, epochs: int) -> List[float]:
        history = []
        for _ in range(epochs):
            losses = [self.train_step(loss_fn, self._batch(b, keys))
                      for b in iterator]
            history.append(float(torch.stack(losses).float().mean()))
        return history

    def fit_classifier(self, iterator, epochs: int = 1) -> List[float]:
        """Sequence-classification fine-tune over ``BertIterator`` batches
        (``ids``, ``segments``, ``mask``, one-hot ``labels``); returns the
        mean loss of each epoch."""
        return self._fit(classification_loss,
                         ("ids", "segments", "mask", "labels"), iterator,
                         epochs)

    def fit_mlm(self, iterator, epochs: int = 1) -> List[float]:
        """Masked-LM training over ``BertIterator(task="unsupervised")``
        batches; returns the mean loss of each epoch."""
        return self._fit(mlm_loss, _MLM_KEYS, iterator, epochs)

    def fit_mlm_scanned(self, batch: Dict[str, Any], steps: int
                        ) -> np.ndarray:
        """``steps`` MLM steps on one fixed device-resident batch with no
        host read between them (the JAX package's ``lax.scan`` over
        ``_mlm_step``): the ``mlm`` unit replayed once a step through
        ``TrainUnits.scan``, each loss copied into a device vector, read
        back once. ``step`` advances by ``steps``. Returns the per-step
        losses."""
        b = self._batch(batch, _MLM_KEYS)
        names = tuple(sorted(b))
        start = self.step

        def advance(_losses):
            self.step = start + steps

        return self._steps.scan(
            "mlm", lambda *t: self._step(mlm_loss, dict(zip(names, t))),
            [b[k] for k in names], steps, per_step=False,
            state=self._donated, signature=observe.signature_of(**b),
            start=start, batch_size=int(b["ids"].shape[0]),
            advance=advance, layout=(names, self.cfg))

    @torch.no_grad()
    def predict(self, ids, segments=None, mask=None) -> np.ndarray:
        """Classification logits (no dropout), as numpy in the model's
        dtype (``nn.dtype.host_array``)."""
        ids = np.asarray(ids)
        b = self._batch({
            "ids": ids,
            "segments": np.zeros_like(ids) if segments is None else segments,
            "mask": np.ones_like(ids) if mask is None else mask},
            ("ids", "segments", "mask"))
        logits = classification_logits(self.params, b["ids"], b["segments"],
                                       b["mask"], self.cfg)
        return host_array(logits)
