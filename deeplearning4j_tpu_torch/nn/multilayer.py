"""MultiLayerNetwork, the sequential network, and the per-layer update
tail shared by the network runtimes.

Counterpart of ``deeplearning4j_tpu/nn/multilayer.py``:

* :func:`apply_layer_updates` (``multilayer.py:84``: L1/L2 into the
  gradient, gradient normalization, the updater through the fused
  ``fused_updater_step`` op, weight decay), :func:`reg_penalty`,
  :func:`aux_losses` and :func:`normalize_gradient` (the
  ``_normalize_gradient`` method at ``multilayer.py:455``, as a function
  of the configuration);
* :class:`MultiLayerNetwork` (``multilayer.py:149``): ``init``, the
  forward with preprocessors and carried RNN state, ``feed_forward``,
  ``output``, ``predict``, ``rnn_time_step`` and its state, the train
  step, truncated BPTT, ``fit`` over arrays / a ``DataSet`` / an
  iterator with its listener calls, its data cursor
  (``batch_in_epoch``: a resumed fit skips the batches the interrupted
  one consumed) and its preemption poll, ``score``, ``evaluate``,
  ``evaluate_regression`` and ``evaluate_roc``, and the flat parameter
  and updater-state views in the JAX package's order
  (``_sorted_leaves``).

What the train step does in place of ``jax.value_and_grad`` + ``jit``:
each parameter leaf is taken as an autograd leaf (``detach()`` +
``requires_grad_``, no copy), the forward and loss run,
``torch.autograd.grad`` gives the gradients, and the update tail runs
under ``torch.no_grad()``: one :meth:`Updater.apply_fused_many` call a
step (one multi-tensor launch of the updater kernel on the card). The
step is a training unit (``nn/compiled.py``): on the card one CUDA-graph
capture per batch signature (keys ``train`` and ``train_tbptt``), replayed
after, with the parameters, updater state, layer state and the device
iteration written in place (the JAX step's donated buffers); on the CPU,
and under ``disable_capture()``, the same function runs eagerly, and on
the CPU the update is out of place (new tensors, rebound), as the JAX
step returns new arrays there. A features mask fed to a network with an
LSTM routes the step to eager execution (cuDNN reads the mask's lengths
on the host). ``fit_scanned`` runs many steps as the unit
``fit_scanned`` with one host read a chunk.

Trees are dicts of tensors (nested for wrapper layers: Bidirectional's
``fwd`` / ``bwd``); leaves are visited in sorted-key order, as
``jax.tree.flatten`` visits a dict. Listeners get each step's loss as
the 0-d device tensor the step returned: ``fit`` adds no host
synchronization a step unless a listener reads the score.
"""

from __future__ import annotations

import contextlib
import functools
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch import faults, observe
from deeplearning4j_tpu_torch.datasets.dataset import (
    DataSet, ListDataSetIterator)
from deeplearning4j_tpu_torch.environment import resolve_device
from deeplearning4j_tpu_torch.eval.evaluation import (
    ROC, Evaluation, RegressionEvaluation)
from deeplearning4j_tpu_torch.nn import conf as C
from deeplearning4j_tpu_torch.nn import dtype as DT
from deeplearning4j_tpu_torch.nn.compiled import (
    TrainUnits, commit, donates, flatten_rnn, mask_routing, tensors_of,
    unflatten_rnn)
from deeplearning4j_tpu_torch.nn.layers import (
    BidirectionalImpl, Layer, apply_preprocessor, build_layer)
from deeplearning4j_tpu_torch.nn.listeners import (
    TrainingListener, notify_fit_done, notify_iteration, notify_preemption)
from deeplearning4j_tpu_torch.ops import collectives
from deeplearning4j_tpu_torch.ops.losses import get_loss

WEIGHT_KEYS = {"W", "RW", "dW", "pW", "Wq", "Wk", "Wv", "Wo"}


def _map_weights(fn, tree, other=None):
    """Apply fn to weight leaves only (the reference regularizes weights,
    not biases/gamma/beta)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _map_weights(fn, v, None if other is None else other[k])
        elif k in WEIGHT_KEYS:
            out[k] = fn(v) if other is None else fn(v, other[k])
        else:
            out[k] = v
    return out


def _weight_leaves(tree):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _weight_leaves(v)
        elif k in WEIGHT_KEYS:
            yield v


def _tree():
    """``models/_tree`` (imported on use: the models package imports the
    networks of this package)."""
    from deeplearning4j_tpu_torch.models import _tree as tree

    return tree


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def init_opt_state(upd, params):
    """The updater state of a parameter tree: the same tree with
    ``upd.init_state(leaf)`` at each leaf (``jax.tree.map(upd.init_state,
    params)``)."""
    return _tree().map_tree(upd.init_state, params)


def autograd_leaves(params):
    """The parameter tree with every leaf an autograd leaf (no copy)."""
    return _tree().map_tree(lambda v: v.detach().requires_grad_(True), params)


def grad_tree(loss, params):
    """d loss / d params as a tree like ``params`` (zeros for unused
    leaves, and for every leaf when the loss is a constant: a graph whose
    outputs carry no loss layer, as the reference's UNet, scores 0 and
    moves nothing, as ``jax.value_and_grad`` of a constant does)."""
    paths = list(_tree().leaf_paths(params))
    if not loss.requires_grad:
        return _tree().map_tree(torch.zeros_like, params)
    grads = torch.autograd.grad(loss, [leaf for _, leaf in paths],
                                allow_unused=True)
    return _tree().rebuild(params, {
        path: g if g is not None else torch.zeros_like(leaf)
        for (path, leaf), g in zip(paths, grads)})


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def normalize_gradient(conf, g: Dict[str, Any]) -> Dict[str, Any]:
    """GradientNormalization semantics (BaseMultiLayerUpdater) on one
    layer's gradient tree."""
    kind = conf.gradient_normalization
    if not kind:
        return g
    thr = conf.gradient_normalization_threshold

    def tree_map(fn, tree):
        return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v)
                for k, v in tree.items()}

    if kind in ("renormalize_l2_per_layer", "clip_l2_per_layer"):
        norm = torch.sqrt(sum(torch.sum(x ** 2) for x in _leaves(g)) + 1e-12)
        if kind == "renormalize_l2_per_layer":
            return tree_map(lambda x: x / norm, g)
        scale = torch.clamp_max(thr / norm, 1.0)
        return tree_map(lambda x: x * scale, g)
    if kind == "clip_element_wise_absolute_value":
        return tree_map(lambda x: torch.clamp(x, -thr, thr), g)
    if kind == "clip_l2_per_param_type":
        def clip_one(x):
            n = torch.sqrt(torch.sum(x ** 2) + 1e-12)
            return x * torch.clamp_max(thr / n, 1.0)
        return tree_map(clip_one, g)
    raise ValueError(f"unknown gradient normalization '{kind}'")


def apply_layer_updates(conf, items, step, *, inplace: bool = False):
    """The per-layer update block: L1/L2 into the gradient, clipping,
    updater math, weight decay (BaseMultiLayerUpdater.update +
    WeightDecay.applyStep).

    items: iterable of (params, grads, opt_state, updater, layer_conf):
    trees of leaf name -> tensor (nested for wrapper layers), and the
    updater state the same tree with a state dict at each leaf. ``step``:
    the iteration, an int or the trainer's int32 device tensor. Returns a
    list of (new_params, new_opt_state) in input order; ``inplace``: the
    given parameter and state tensors hold the new values and are the
    ones returned.

    Each leaf sees the reference's order: its layer's L1/L2 and gradient
    normalization, the updater step, its layer's weight decay (of the
    weight before the step: taken before an in-place step overwrites it).
    The updater steps of all layers that share an updater (and so one lr)
    go in one :meth:`Updater.apply_fused_many` call: one multi-tensor
    launch for the whole network on the card."""
    layers = []
    groups: List[tuple] = []  # (updater, [(layer, leaf path)]), equal configs
    for i, (p, g, s, upd, lc) in enumerate(items):
        l1 = conf.layer_l1(lc)
        l2 = conf.layer_l2(lc)
        if l2:
            g = _map_weights(lambda gw, w: gw + l2 * w, g, p)
        if l1:
            g = _map_weights(lambda gw, w: gw + l1 * torch.sign(w), g, p)
        g = normalize_gradient(conf, g)
        wd = conf.layer_weight_decay(lc)
        decay = None
        if wd:
            lr = upd.lr(step)
            decay = _map_weights(lambda w: lr * wd * w, p)
        layers.append((p, g, s, upd, lc, {}, {}, decay))
        leaves = next((lv for u, lv in groups if u == upd), None)
        if leaves is None:
            leaves = []
            groups.append((upd, leaves))
        leaves.extend((i, path) for path, _ in _tree().leaf_paths(p))
    for upd, leaves in groups:
        new_p, new_s = upd.apply_fused_many(
            [_at(layers[i][0], path) for i, path in leaves],
            [_at(layers[i][1], path) for i, path in leaves],
            [_at(layers[i][2], path) for i, path in leaves],
            upd.lr(step), step, inplace=inplace)
        for (i, path), np_, ns in zip(leaves, new_p, new_s):
            layers[i][5][path], layers[i][6][path] = np_, ns
    out = []
    for p, _, _, upd, lc, by_path, state_by_path, decay in layers:
        new_p = _tree().rebuild(p, by_path)
        new_s = _tree().rebuild(p, state_by_path)
        if decay is not None and inplace:
            for w, d in zip(_weight_leaves(new_p), _weight_leaves(decay)):
                w.sub_(d)
        elif decay is not None:
            new_p = _map_weights(lambda w, d: w - d, new_p, decay)
        out.append((new_p, new_s))
    return out


def aux_losses(new_state, device=None) -> torch.Tensor:
    """Sum the differentiable side losses layers keep in their state under
    ``_aux_loss`` (a ``MoELayer``'s load-balance loss), from a zero on
    ``device`` (the step's: no host constant enters a captured step)."""
    states = new_state.values() if isinstance(new_state, dict) else new_state
    total = torch.zeros((), device=device)
    for st in states:
        if isinstance(st, dict) and "_aux_loss" in st:
            total = total + st["_aux_loss"]
    return total


def reg_penalty(conf, items, device=None) -> torch.Tensor:
    """Score regularization penalty (BaseLayer.calcRegularizationScore);
    items: iterable of (params, layer_conf); summed from a zero on
    ``device``."""
    penalty = torch.zeros((), device=device)
    for p, lc in items:
        l1 = conf.layer_l1(lc)
        l2 = conf.layer_l2(lc)
        if l2:
            penalty = penalty + 0.5 * l2 * sum(
                torch.sum(w.float() ** 2) for w in _weight_leaves(p))
        if l1:
            penalty = penalty + l1 * sum(
                torch.sum(torch.abs(w.float()))
                for w in _weight_leaves(p))
    return penalty


class MultiLayerNetwork:
    """Sequential network over a :class:`~.conf.MultiLayerConfiguration`
    (MultiLayerNetwork.java), on one device: ``"cuda"`` unless the caller
    passes ``device="cpu"``. ``params`` and ``opt_state`` are lists with
    one tree a layer; dropout draws from one ``torch.Generator`` on the
    device (``_gen``), seeded from the configuration's seed.
    ``batch_in_epoch`` counts the batches of the current epoch already
    trained (the data cursor a checkpoint carries). ``_steps`` holds the
    compiled training steps and the device iteration."""

    def __init__(self, conf: C.MultiLayerConfiguration, *, device=None):
        self.conf = conf
        self.device = resolve_device(device)
        self.layers: List[Layer] = []
        itype = conf.input_type
        for i, lc in enumerate(conf.layers):
            pre = conf.preprocessors.get(i)
            if pre is not None and itype is not None:
                if isinstance(pre, C.FeedForwardToCnnPreProcessor):
                    itype = C.InputType.convolutional(pre.height, pre.width,
                                                      pre.channels)
                elif isinstance(pre, (C.CnnToFeedForwardPreProcessor,
                                      C.Cnn3DToFeedForwardPreProcessor)):
                    itype = C.InputType.feed_forward(
                        getattr(pre, "depth", 1) * pre.height * pre.width
                        * pre.channels)
            layer = build_layer(conf, lc, itype or C.InputType.feed_forward(0),
                                self.device)
            self.layers.append(layer)
            itype = layer.otype
        self.updaters = [conf.layer_updater(lc) for lc in conf.layers]
        self.params: Optional[List[Dict[str, Any]]] = None
        self.net_state: Optional[List[Dict[str, Any]]] = None
        self.opt_state: Optional[List[Any]] = None
        self.iteration_count = 0
        self.epoch_count = 0
        self.batch_in_epoch = 0
        self.last_batch_size = 0
        self.listeners: List[TrainingListener] = []
        self._score: Optional[torch.Tensor] = None
        self._tbptt_scores: List[torch.Tensor] = []
        self._rnn_states: Optional[List[Any]] = None
        self._gen = torch.Generator(device=self.device).manual_seed(conf.seed)
        self._steps = TrainUnits(self.device, "mln", [self._gen])
        # restored train steps (autodiff/export.py): "train_step" -> the
        # exported program the ``train`` unit runs in place of _step
        self._jit_cache: Dict[str, Any] = {}
        last = conf.layers[-1] if conf.layers else None
        self._loss_name = getattr(last, "loss", None)
        if hasattr(last, "loss_fn"):  # the configuration binds its own
            self._loss_fn = last.loss_fn()
        else:
            self._loss_fn = (get_loss(self._loss_name) if self._loss_name
                             else None)

    # ------------------------------------------------------------------ init
    def init(self, params=None) -> "MultiLayerNetwork":
        """Parameters from ``params`` (one tree a layer, numpy arrays as
        the JAX package's ``jax.tree.map(np.asarray, net.params)`` gives
        them, or tensors; moved to the network's device) or drawn from the
        configuration's seed; fresh layer state and updater state."""
        if params is not None:
            self.params = _tree().params_from_numpy(list(params), self.device)
        else:
            gen = torch.Generator().manual_seed(self.conf.seed)
            self.params = [layer.init(gen) for layer in self.layers]
        self.net_state = [layer.init_state() for layer in self.layers]
        self.opt_state = [init_opt_state(upd, p)
                          for upd, p in zip(self.updaters, self.params)]
        return self

    def set_listeners(self, *ls: TrainingListener) -> None:
        self.listeners = list(ls)

    def add_listeners(self, *ls: TrainingListener) -> None:
        self.listeners.extend(ls)

    # --------------------------------------------------------------- forward
    def _forward(self, params, net_state, x, mask, *, train: bool, rng,
                 rnn_states=None, tap_input_of: Optional[int] = None):
        """Preprocessors and layers: (out, new layer state), or with
        ``rnn_states`` (one entry a layer, None for the non-recurrent
        ones) (out, new layer state, new rnn states): the tBPTT /
        ``rnn_time_step`` path, where each recurrent layer starts from its
        carried state. ``tap_input_of``: (out, new layer state, the input
        of that layer) — the features a center loss reads."""
        if DT.needs_cast(self.conf.dtype):
            # mixed policy: the ONE cast of parameters and inputs to bf16
            cd = DT.compute_dtype(self.conf.dtype)
            params = DT.cast_floats(params, cd)
            x = DT.cast_floats(x, cd)
            if rnn_states is not None:
                rnn_states = DT.cast_floats(rnn_states, cd)
        # "bfloat16" / "float16": the parameters are stored 16-bit and the
        # inputs keep their dtype; each layer op promotes its operands as
        # jnp does (nn.dtype.promote), so float32 inputs compute and come
        # out in float32, as in the JAX package
        new_state = []
        new_rnn = [] if rnn_states is not None else None
        tapped = None
        for i, layer in enumerate(self.layers):
            x = apply_preprocessor(self.conf.preprocessors.get(i), x)
            if i == tap_input_of:
                tapped = x
            if rnn_states is not None and hasattr(layer, "apply_with_state"):
                x = layer._maybe_dropout(x, train=train, rng=rng)
                x, last = layer.apply_with_state(params[i], x, mask=mask,
                                                 initial=rnn_states[i])
                new_rnn.append(last)
                new_state.append(net_state[i])
            else:
                x, st, mask = layer.apply(params[i], x, net_state[i],
                                          train=train, rng=rng, mask=mask)
                new_state.append(st)
                if new_rnn is not None:
                    new_rnn.append(None)
        if DT.needs_cast(self.conf.dtype):
            x = DT.cast_floats(x, torch.float32)  # loss/eval math in f32
        if rnn_states is not None:
            return x, new_state, new_rnn
        if tap_input_of is not None:
            return x, new_state, tapped
        return x, new_state

    def _center_loss(self, params, feats, y):
        """CenterLossOutputLayer's decoupled center loss (JAX
        ``multilayer.py:361``): λ·½‖f − sg(c_y)‖² pulls the features toward
        the detached centers, α·½‖sg(f) − c_y‖² the centers toward the
        detached features (its gradient α(c_y − f̄) is the reference's
        moving-average center update, taken by the optimizer)."""
        lc = self.conf.layers[-1]
        dt = torch.promote_types(torch.float32, feats.dtype)
        f = feats.to(dt)
        centers = params[-1]["centers"].to(dt)
        c_y = centers[torch.argmax(y, dim=-1)]
        d_feat = f - c_y.detach()
        d_ctr = f.detach() - c_y
        return (0.5 * lc.lambda_ * torch.mean(torch.sum(d_feat * d_feat, -1))
                + 0.5 * lc.alpha * torch.mean(torch.sum(d_ctr * d_ctr, -1)))

    def _feed(self, a):
        # in the dtypes the JAX package computes in (float64 → float32,
        # int64 → int32)
        from deeplearning4j_tpu_torch.autodiff.samediff import canonical

        return None if a is None else canonical(a, self.device)

    def feed_forward(self, x, train: bool = False) -> List[np.ndarray]:
        """Each layer's activations (MultiLayerNetwork.feedForward)."""
        acts = []
        xt, mask = self._feed(x), None
        with torch.no_grad(), DT.precision_scope(self.conf.dtype):
            for i, layer in enumerate(self.layers):
                xt = apply_preprocessor(self.conf.preprocessors.get(i), xt)
                xt, _, mask = layer.apply(self.params[i], xt,
                                          self.net_state[i], train=train,
                                          rng=self._gen, mask=mask)
                acts.append(DT.host_array(xt))
        return acts

    def _output_tensor(self, x, mask=None) -> torch.Tensor:
        """The inference forward's result on the device, in its own dtype."""
        with torch.no_grad(), DT.precision_scope(self.conf.dtype):
            out, _ = self._forward(self.params, self.net_state,
                                   self._feed(x), self._feed(mask),
                                   train=False, rng=None)
        return out

    def output(self, x, mask=None) -> np.ndarray:
        """Inference forward (MultiLayerNetwork.output), as numpy."""
        return DT.host_array(self._output_tensor(x, mask))

    def predict(self, x) -> np.ndarray:
        return self.output(x).argmax(axis=-1)

    # ------------------------------------------------------ stateful RNN API
    def rnn_time_step(self, x, mask=None) -> np.ndarray:
        """Stateful streaming inference (MultiLayerNetwork.rnnTimeStep):
        (N, T, F), or (N, F) for one step, carrying each recurrent layer's
        state across calls."""
        x = np.asarray(x)
        squeeze = x.ndim == 2
        if squeeze:
            x = x[:, None, :]
        xt = self._feed(x)
        if self._rnn_states is None:
            # the first state in the input's float dtype, as the JAX
            # package seeds it (16-bit input streams 16-bit state)
            self._rnn_states = self._zero_rnn_states(
                x.shape[0], xt.dtype if xt.is_floating_point()
                else torch.float32)
        with torch.no_grad(), DT.precision_scope(self.conf.dtype):
            out, _, self._rnn_states = self._forward(
                self.params, self.net_state, xt, self._feed(mask),
                train=False, rng=None, rnn_states=self._rnn_states)
        out = DT.host_array(out)
        return out[:, -1] if squeeze else out

    def rnn_clear_previous_state(self) -> None:
        self._rnn_states = None

    def rnn_get_previous_state(self, layer_idx: int):
        states = self._rnn_states
        return None if states is None else states[layer_idx]

    def _zero_rnn_states(self, batch: int, dtype=torch.float32):
        states = []
        for layer in self.layers:
            if isinstance(layer, BidirectionalImpl):
                # the reference's rnnTimeStep refuses them too: the
                # backward direction needs the future
                raise ValueError(
                    "stateful RNN state (rnn_time_step / tBPTT) is not "
                    "supported with Bidirectional layers")
            states.append(layer.zero_state(batch, dtype)
                          if hasattr(layer, "zero_state") else None)
        return states

    # ------------------------------------------------------------ train step
    def _donated(self) -> list:
        """The tensors a training step writes in place: parameters,
        updater state, layer state and the device iteration."""
        return tensors_of(self.params, self.opt_state, self.net_state) + [
            self._steps.iteration.tensor]

    def _step(self, x, y, fmask, lmask, rnn_states=None, *,
              grad_scopes: bool = True):
        """The step's body: loss and gradients by autograd, the update
        tail under no_grad, the iteration advanced on the device. Returns
        the score (loss + the regularization penalty of the parameters
        before the update, a 0-d tensor on the device) and, with
        ``rnn_states``, the carried states, detached: gradients stop at the
        segment boundary. ``grad_scopes=False`` switches no grad mode (the
        caller runs it with autograd on): the form ``torch.export`` traces
        (``autodiff/export.py``); the tail builds no graph either way, as
        it reads no tensor that requires grad."""
        step = self._steps.iteration.tensor
        donate = donates(self.device)
        scope = ((torch.enable_grad, torch.no_grad) if grad_scopes
                 else (contextlib.nullcontext, contextlib.nullcontext))
        with DT.precision_scope(self.conf.dtype):
            with scope[0]():
                leaves = autograd_leaves(self.params)
                # the leaves a ParallelWrapper rank holds sharded, whole
                params = collectives.forward_params(leaves)
                center = (rnn_states is None and isinstance(
                    self.conf.layers[-1], C.CenterLossOutputLayer))
                res = self._forward(
                    params, self.net_state, x, fmask, train=True,
                    rng=self._gen, rnn_states=rnn_states,
                    tap_input_of=len(self.layers) - 1 if center else None)
                out, new_state = res[0], res[1]
                if center:
                    loss = self._loss_fn(out, y, lmask) + self._center_loss(
                        params, res[2], y)
                else:
                    loss = self._loss_fn(out, y, lmask) + aux_losses(
                        new_state, self.device)
                grads = collectives.reduce_gradients(grad_tree(loss, leaves))
            with scope[1]():
                score = collectives.mean_loss(loss.detach()) + reg_penalty(
                    self.conf, zip(_tree().map_tree(torch.Tensor.detach,
                                                    params),
                                   self.conf.layers), self.device)
                updated = apply_layer_updates(
                    self.conf, zip(self.params, grads, self.opt_state,
                                   self.updaters, self.conf.layers), step,
                    inplace=donate)
                new_state = [{k: v.detach() for k, v in st.items()}
                             for st in new_state]
                if donate:
                    self.net_state = commit(self.net_state, new_state)
                else:
                    self.params = [p for p, _ in updated]
                    self.opt_state = [s for _, s in updated]
                    self.net_state = new_state
                step.add_(1)
        if rnn_states is None:
            return score
        return (score,) + tuple(flatten_rnn([_detached(st)
                                             for st in res[2]])[0])

    def _train_step(self, x, y, fmask, lmask, rnn_states=None):
        """One step (one tBPTT segment with ``rnn_states``) as the training
        unit ``train`` / ``train_tbptt`` (module docstring). Returns the
        score (a 0-d device tensor) and the carried states (None without
        ``rnn_states``)."""
        if self._loss_fn is None:
            raise ValueError("terminal layer has no loss configured")
        self._steps.iteration.at(self.iteration_count)
        rnn_flat, rnn_spec = ([], None) if rnn_states is None else (
            flatten_rnn(rnn_states))
        args = [x, y] + [m for m in (fmask, lmask) if m is not None]
        layout = (fmask is not None, lmask is not None, rnn_spec)
        signature = observe.signature_of(x=x, y=y, fm=fmask, lm=lmask)
        exported = self._jit_cache.get("train_step")
        if (exported is not None and rnn_states is None
                and exported.fits(x, y, fmask, lmask)):
            # the restored program (autodiff/export.py) as the unit's body
            out = self._steps.run(
                "train", exported, args, layout=("aot",) + layout,
                state=self._donated(), signature=signature,
                note=lambda unit: observe.note_jit_signature(
                    exported, graph="mln", key="train",
                    signature=signature))
            self._steps.iteration.advanced()
            return out, None

        def body(x, y, *rest):
            rest = list(rest)
            fm = rest.pop(0) if layout[0] else None
            lm = rest.pop(0) if layout[1] else None
            carried = None if rnn_spec is None else unflatten_rnn(rnn_spec,
                                                                  rest)
            return self._step(x, y, fm, lm, carried)

        out = self._steps.run(
            "train" if rnn_states is None else "train_tbptt", body,
            args + rnn_flat, layout=layout, state=self._donated(),
            signature=signature,
            eager_reason=(mask_routing(self.layers, (fmask,))
                          or collectives.routing()))
        self._steps.iteration.advanced()
        if rnn_states is None:
            return out, None
        return out[0], unflatten_rnn(rnn_spec, out[1:])

    def _fit_tbptt_batch(self, x, y, fmask, lmask):
        """The time axis cut into ``tbptt_fwd_length`` segments, the RNN
        state carried (detached) from one to the next; one update a
        segment."""
        if y.ndim < 3:
            raise ValueError(
                "tBPTT requires 3-D time-series labels (N, T, C); got shape "
                f"{tuple(y.shape)}: use standard backprop for per-sequence "
                "labels")
        fwd = self.conf.tbptt_fwd_length
        t = x.shape[1]
        rnn_states = self._zero_rnn_states(x.shape[0])
        segments = list(range(0, t, fwd))
        self._tbptt_scores = []
        for i, t0 in enumerate(segments):
            sl = slice(t0, min(t0 + fwd, t))
            score, rnn_states = self._train_step(
                x[:, sl], y[:, sl], None if fmask is None else fmask[:, sl],
                None if lmask is None else lmask[:, sl], rnn_states)
            self._tbptt_scores.append(score)
            # the iteration advances once a segment (Adam's bias
            # correction, schedules); fit() adds the last segment's
            if i < len(segments) - 1:
                self.iteration_count += 1
        return score

    def tbptt_scores(self) -> List[float]:
        """The scores of the last tBPTT batch's segments, in order."""
        return [float(s) for s in self._tbptt_scores]

    # ------------------------------------------------------------------- fit
    def fit(self, data, labels=None, epochs: int = 1,
            batch_size: int = 32) -> None:
        """fit(DataSetIterator | DataSet | (features, labels)): one train
        step a minibatch, or one a tBPTT segment when the configuration
        says ``backprop_type="tbptt"``.

        Each batch first polls the ``preemption`` fault point (a hard
        kill: it raises, for a supervisor to restore and resume) and the
        graceful-preemption flag (``notify_preemption``, then return). A
        fit resumed mid-epoch skips the ``batch_in_epoch`` batches the
        interrupted one trained."""
        if labels is not None:
            data = ListDataSetIterator(DataSet(data, labels),
                                       batch_size=batch_size)
        elif isinstance(data, DataSet):
            data = ListDataSetIterator(data, batch_size=batch_size)
        tbptt = (self.conf.backprop_type == "tbptt"
                 and self.conf.tbptt_fwd_length > 0)
        m = observe.metrics()
        steps_c = m.counter("dl4j_tpu_train_steps_total", model="mln")
        ex_c = m.counter("dl4j_tpu_train_examples_total", model="mln")
        xfer_c = m.counter("dl4j_tpu_host_to_device_transfers_total",
                           model="mln")
        step_h = m.histogram("dl4j_tpu_train_step_seconds", model="mln")
        for _ in range(epochs):
            for lst in self.listeners:
                lst.on_epoch_start(self)
            t_prev = time.perf_counter()
            n_steps = 0
            skip = self.batch_in_epoch  # nonzero only on a resume
            for bi, ds in enumerate(data):
                if bi < skip:
                    continue
                faults.maybe_fail("preemption")
                if faults.preemption_requested():
                    notify_preemption(self, self.listeners)
                    return
                self.last_batch_size = ds.num_examples()
                x, y = self._feed(ds.features), self._feed(ds.labels)
                fm, lm = self._feed(ds.features_mask), self._feed(
                    ds.labels_mask)
                if tbptt:
                    self._score = self._fit_tbptt_batch(x, y, fm, lm)
                else:
                    self._score, _ = self._train_step(x, y, fm, lm)
                self.iteration_count += 1
                self.batch_in_epoch = bi + 1  # before listeners save
                now = time.perf_counter()
                step_h.observe(now - t_prev)
                t_prev = now
                n_steps += 1
                steps_c.inc()
                ex_c.inc(ds.num_examples())
                xfer_c.inc(2 + (ds.features_mask is not None)
                           + (ds.labels_mask is not None))
                # the loss as a device tensor: no host sync unless a
                # listener reads it
                for lst in self.listeners:
                    lst.iteration_done(self, self.iteration_count,
                                       self.epoch_count, self._score)
            self.batch_in_epoch = 0
            self.epoch_count += 1
            observe.log_event("train_epoch", model="mln",
                              epoch=self.epoch_count, steps=n_steps)
            for lst in self.listeners:
                lst.on_epoch_end(self)
        notify_fit_done(self, self.listeners)

    def fit_scanned(self, features, labels, steps: Optional[int] = None,
                    *, features_mask=None, labels_mask=None) -> np.ndarray:
        """Many train steps with no host read between them (the JAX
        package's ``lax.scan`` over the train step): the training unit
        ``fit_scanned`` replayed once a step, the iteration and the
        schedules advancing on the device, the per-step losses read back
        once.

        Two modes, as in the JAX package: ``steps`` given — train
        ``steps`` times on the one device-resident batch; ``steps`` None —
        ``features`` / ``labels`` carry a leading [steps, batch, ...] axis
        of per-step minibatches, staged to the device once. Masks are
        refused (use ``fit``). Listeners fire after the chunk, once a step
        in iteration-major order, with the step's iteration number and
        loss. Returns the per-step losses (float32 numpy)."""
        if features_mask is not None or labels_mask is not None:
            raise ValueError("fit_scanned takes no masks, as in the JAX "
                             "package: use fit()")
        if self._loss_fn is None:
            raise ValueError("terminal layer has no loss configured")
        per_step = steps is None
        xs, ys = self._feed(features), self._feed(labels)
        n_steps = int(xs.shape[0]) if per_step else int(steps)
        start = self.iteration_count
        self.last_batch_size = int(xs.shape[1] if per_step else xs.shape[0])

        def advance(losses):
            self.iteration_count = start + n_steps
            self._score = losses[-1]

        return self._steps.scan(
            "fit_scanned", lambda x, y: self._step(x, y, None, None),
            (xs, ys), n_steps, per_step=per_step, state=self._donated,
            signature=observe.signature_of(x=xs, y=ys), start=start,
            batch_size=self.last_batch_size, advance=advance,
            notify=functools.partial(notify_iteration, self))

    def score(self, ds: Optional[DataSet] = None) -> float:
        """The loss on ``ds``, or the last training score."""
        if ds is None:
            return float("nan") if self._score is None else float(self._score)
        # from the forward's own tensor, in its dtype, as the JAX package
        # scores the 16-bit array ``output`` returns
        out = self._output_tensor(ds.features, ds.features_mask)
        with torch.no_grad():
            return float(self._loss_fn(out, self._feed(ds.labels),
                                       self._feed(ds.labels_mask)))

    # -------------------------------------------------------------- evaluate
    def evaluate(self, iterator, evaluation=None):
        """evaluate(DataSetIterator | DataSet) → the ``evaluation``
        accumulator (an ``Evaluation`` unless one is given) over
        ``output`` of every batch."""
        return evaluate_batches(iterator, evaluation, lambda ds: (
            self.output(ds.features, ds.features_mask)))

    def evaluate_regression(self, iterator) -> RegressionEvaluation:
        return self.evaluate(iterator, RegressionEvaluation())

    def evaluate_roc(self, iterator) -> ROC:
        return self.evaluate(iterator, ROC())

    # ------------------------------------------------------- flattened views
    def params_flat(self) -> np.ndarray:
        """One flat float32 vector (MultiLayerNetwork.params()): layer
        order, then sorted keys within a layer."""
        return flatten_trees(self.params)

    def set_params_flat(self, flat) -> None:
        self.params, offset = unflatten_trees(self.params, flat, self.device)
        if offset != np.asarray(flat).size:
            raise ValueError(f"param vector length {np.asarray(flat).size} "
                             f"!= model size {offset}")

    def num_params(self) -> int:
        return sum(leaf.numel() for p in self.params
                   for _, leaf in _tree().leaf_paths(p))

    def updater_state_flat(self) -> np.ndarray:
        return flatten_trees(self.opt_state)

    def set_updater_state_flat(self, flat) -> None:
        self.opt_state, _ = unflatten_trees(self.opt_state, flat, self.device)


def evaluate_batches(iterator, evaluation, output_fn):
    """The ``evaluate`` loop both networks share: ``evaluation`` (an
    ``Evaluation`` unless one is given) fed ``output_fn(ds)`` against
    the labels of every batch of ``iterator`` (a DataSet is cut into
    batches of 256)."""
    e = evaluation if evaluation is not None else Evaluation()
    if isinstance(iterator, DataSet):
        iterator = ListDataSetIterator(iterator, batch_size=256)
    for ds in iterator:
        e.eval(ds.labels, output_fn(ds), ds.labels_mask)
    return e


def _detached(state):
    """A carried RNN state ((h, c) for an LSTM, h for a GRU or SimpleRnn,
    None for other layers) cut from the graph that made it."""
    if state is None:
        return None
    if isinstance(state, tuple):
        return tuple(t.detach() for t in state)
    return state.detach()


def flatten_trees(trees) -> np.ndarray:
    """The leaves of a list of trees in ``_sorted_leaves`` order (sorted
    keys, depth first), concatenated as float32."""
    leaves = [leaf for tree in trees for _, leaf in _tree().leaf_paths(tree)]
    if not leaves:
        return np.zeros((0,), np.float32)
    return np.concatenate([leaf.detach().float().reshape(-1).cpu().numpy()
                           for leaf in leaves])


def unflatten_trees(trees, flat, device):
    """Trees like ``trees`` (shapes and dtypes) read from ``flat`` in
    :func:`flatten_trees`'s order. Returns (trees, values read)."""
    flat = np.asarray(flat)
    offset = 0
    by_tree = []
    for tree in trees:
        by_path = {}
        for path, leaf in _tree().leaf_paths(tree):
            n = leaf.numel()
            chunk = flat[offset:offset + n].reshape(tuple(leaf.shape))
            by_path[path] = torch.from_numpy(np.array(chunk)).to(
                device=device, dtype=leaf.dtype)
            offset += n
        by_tree.append(_tree().rebuild(tree, by_path))
    return by_tree, offset
