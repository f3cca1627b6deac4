"""The per-layer update tail shared by the network runtimes.

Counterpart of the shared part of ``deeplearning4j_tpu/nn/multilayer.py``:
:func:`apply_layer_updates` (``multilayer.py:84``: L1/L2 into the
gradient, gradient normalization, the updater through the fused
``fused_updater_step`` op, weight decay), :func:`reg_penalty`,
:func:`aux_losses` and :func:`normalize_gradient` (the
``_normalize_gradient`` method at ``multilayer.py:455``, as a function of
the configuration). ``MultiLayerNetwork`` itself is not ported yet.

Trees are dicts of tensors; leaves are visited in sorted-key order, as
``jax.tree.flatten`` visits a dict. Called under ``torch.no_grad()``;
every update is out of place (new tensors).
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch

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


def apply_layer_updates(conf, items, step):
    """The per-layer update block: L1/L2 into the gradient, clipping,
    updater math, weight decay (BaseMultiLayerUpdater.update +
    WeightDecay.applyStep).

    items: iterable of (params, grads, opt_state, updater, layer_conf),
    trees of one level (leaf name -> tensor; opt_state leaf name -> state
    dict). Returns a list of (new_params, new_opt_state) in input order.

    Each leaf sees the reference's order: its layer's L1/L2 and gradient
    normalization, the updater step, its layer's weight decay. The updater
    steps of all layers that share an updater (and so one lr) go in one
    :meth:`Updater.apply_fused_many` call: one multi-tensor launch for the
    whole network on the card."""
    layers = []
    groups: List[tuple] = []  # (updater, [(layer, leaf name)]), equal configs
    for i, (p, g, s, upd, lc) in enumerate(items):
        l1 = conf.layer_l1(lc)
        l2 = conf.layer_l2(lc)
        if l2:
            g = _map_weights(lambda gw, w: gw + l2 * w, g, p)
        if l1:
            g = _map_weights(lambda gw, w: gw + l1 * torch.sign(w), g, p)
        g = normalize_gradient(conf, g)
        layers.append((p, g, s, upd, lc, {}, {}))
        leaves = next((lv for u, lv in groups if u == upd), None)
        if leaves is None:
            leaves = []
            groups.append((upd, leaves))
        leaves.extend((i, k) for k in sorted(p))
    for upd, leaves in groups:
        new_p, new_s = upd.apply_fused_many(
            [layers[i][0][k] for i, k in leaves],
            [layers[i][1][k] for i, k in leaves],
            [layers[i][2][k] for i, k in leaves], upd.lr(step), step)
        for (i, k), np_, ns in zip(leaves, new_p, new_s):
            layers[i][5][k], layers[i][6][k] = np_, ns
    out = []
    for p, _, _, upd, lc, new_p, new_s in layers:
        wd = conf.layer_weight_decay(lc)
        if wd:
            lr = upd.lr(step)
            new_p = _map_weights(lambda w, w0: w - lr * wd * w0, new_p, p)
        out.append((new_p, new_s))
    return out


def aux_losses(new_state) -> torch.Tensor:
    """Sum the differentiable side losses layers keep in their state under
    ``_aux_loss`` (none on the ported layers)."""
    states = new_state.values() if isinstance(new_state, dict) else new_state
    total = torch.zeros(())
    for st in states:
        if isinstance(st, dict) and "_aux_loss" in st:
            total = total + st["_aux_loss"]
    return total


def reg_penalty(conf, items) -> torch.Tensor:
    """Score regularization penalty (BaseLayer.calcRegularizationScore);
    items: iterable of (params, layer_conf)."""
    penalty = torch.zeros(())
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
