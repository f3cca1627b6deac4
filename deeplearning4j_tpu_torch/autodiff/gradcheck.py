"""Gradient checking: autograd against central finite differences, in
float64 on the CPU.

Counterpart of ``deeplearning4j_tpu/autodiff/gradcheck.py``
(GradientCheckUtil / GradCheckUtil analogs): the same thresholds, the same
coordinate subsampling and the same relative-error rule, for a function
of a dict of leaves (:func:`check_gradients_fn`), a ``MultiLayerNetwork``
(:func:`check_gradients`) and a SameDiff graph. What differs:
:func:`check_samediff_gradients` runs the graph through the optimizer's
plan when the graph has the optimizer on (the JAX package runs the
recording), so the fused nodes — ``fused_layer_norm``,
``fused_matmul_bias_act``, ``dot_product_attention`` — are checked as the
training step runs them, by their generic float64 ops.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

DEFAULT_EPS = 1e-6
# f64 central differences at eps=1e-6 carry ~1e-10 intrinsic error, so
# 1e-5 is a real bound (the reference's DOUBLE-mode checks use the same)
DEFAULT_MAX_REL_ERROR = 1e-5
DEFAULT_MIN_ABS_ERROR = 1e-8


def _rel_error(a: float, n: float, min_abs: float) -> float:
    if abs(a - n) < min_abs:
        return 0.0
    denom = abs(a) + abs(n)
    return abs(a - n) / denom if denom > 0 else 0.0


def _f64(value) -> torch.Tensor:
    """A CPU tensor, floating types widened to float64."""
    t = (value.detach().cpu() if isinstance(value, torch.Tensor)
         else torch.from_numpy(np.array(value)))
    return t.double() if t.is_floating_point() else t


def check_gradients_fn(loss_fn: Callable[[Dict[str, torch.Tensor]],
                                         torch.Tensor],
                       params: Dict[str, object], *,
                       eps: float = DEFAULT_EPS,
                       max_rel_error: float = DEFAULT_MAX_REL_ERROR,
                       min_abs_error: float = DEFAULT_MIN_ABS_ERROR,
                       max_per_param: int = 25, seed: int = 0,
                       print_failures: bool = True) -> bool:
    """Check autograd of ``loss_fn`` (a dict of float64 leaves -> scalar)
    against central finite differences on up to ``max_per_param``
    randomly chosen coordinates of each leaf, leaves in sorted-name order
    (the order ``jax.tree`` flattens a dict in)."""
    names = sorted(params)
    values = {n: _f64(params[n]) for n in names}
    leaves = [values[n].clone().requires_grad_(True) for n in names]
    with torch.enable_grad():
        loss = loss_fn(dict(zip(names, leaves)))
        analytic = torch.autograd.grad(loss, leaves, allow_unused=True)
    rng = np.random.RandomState(seed)
    ok = True
    with torch.no_grad():
        for li, (name, g) in enumerate(zip(names, analytic)):
            p_np = values[name].numpy()
            g_np = (np.zeros_like(p_np) if g is None
                    else g.numpy().astype(np.float64))
            n = p_np.size
            idxs = (range(n) if n <= max_per_param
                    else rng.choice(n, max_per_param, replace=False))
            for i in idxs:
                orig = p_np.reshape(-1)[i]

                def loss_at(v):
                    pp = p_np.copy().reshape(-1)
                    pp[i] = v
                    moved = dict(values)
                    moved[name] = torch.from_numpy(pp.reshape(p_np.shape))
                    return float(loss_fn(moved))

                num = (loss_at(orig + eps) - loss_at(orig - eps)) / (2 * eps)
                ana = g_np.reshape(-1)[i]
                rel = _rel_error(ana, num, min_abs_error)
                if rel > max_rel_error:
                    ok = False
                    if print_failures:
                        print(f"GRADCHECK FAIL leaf {li} ({name}) idx {i}: "
                              f"analytic={ana:.8g} numeric={num:.8g} "
                              f"rel={rel:.3g}")
    return ok


def check_gradients(net, features, labels, *, eps: float = DEFAULT_EPS,
                    max_rel_error: float = DEFAULT_MAX_REL_ERROR,
                    min_abs_error: float = DEFAULT_MIN_ABS_ERROR,
                    max_per_param: int = 25, seed: int = 0,
                    features_mask=None, labels_mask=None) -> bool:
    """GradientCheckUtil.checkGradients(MultiLayerNetwork, ...) analog
    (JAX ``gradcheck.py:94``): the network's forward and loss with
    ``train=False`` (no dropout, no batch-norm statistics update), in
    float64, on a CPU twin of the network (the same configuration, the
    parameters and layer state copied), whichever device ``net`` is on.
    Leaves are checked in the order ``jax.tree`` flattens ``net.params``
    (layers in order, keys sorted), so the coordinates drawn from
    ``seed`` are the JAX package's."""
    from deeplearning4j_tpu_torch.models._tree import (
        leaf_paths, map_tree, rebuild)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    twin = MultiLayerNetwork(net.conf, device="cpu")
    if twin._loss_fn is None:
        raise ValueError("terminal layer has no loss configured")
    # names that sort as jax.tree orders the leaves: the layer index
    # zero-padded, then the key path
    paths = list(leaf_paths(net.params))
    names = [f"{path[0]:06d}/" + "/".join(map(str, path[1:]))
             for path, _ in paths]
    x, y, fm, lm = (None if a is None else _f64(a)
                    for a in (features, labels, features_mask, labels_mask))
    state = map_tree(_f64, net.net_state)

    def loss_fn(leaves):
        params = rebuild(net.params, {path: leaves[n] for (path, _), n
                                      in zip(paths, names)})
        out, _ = twin._forward(params, state, x, fm, train=False, rng=None)
        return twin._loss_fn(out, y, lm)

    return check_gradients_fn(
        loss_fn, {n: leaf for n, (_, leaf) in zip(names, paths)}, eps=eps,
        max_rel_error=max_rel_error, min_abs_error=min_abs_error,
        max_per_param=max_per_param, seed=seed, print_failures=True)


def check_samediff_gradients(sd, feeds: Dict[str, np.ndarray],
                             loss_name: str, *, eps: float = DEFAULT_EPS,
                             max_rel_error: float = DEFAULT_MAX_REL_ERROR,
                             max_per_param: int = 25, seed: int = 0) -> bool:
    """GradCheckUtil.checkGradients(SameDiff) analog: every VARIABLE of
    ``sd`` checked in float64 on the CPU, the graph run through the plan
    its ``output`` uses (the recording when the optimizer is off)."""
    from deeplearning4j_tpu_torch.autodiff.samediff import canonical

    plan = sd._graph_plan((loss_name,))
    trainable = sd._trainable()
    env0 = {n: _f64(a) for n, a in sd._arrays.items() if n not in trainable}
    if plan is not None:
        env0.update((n, _f64(a)) for n, a in plan.extra_consts.items())
    env0.update((k, _f64(canonical(v))) for k, v in feeds.items())

    def loss_fn(params):
        env = dict(env0)
        env.update(params)
        return sd._interpret(env, [loss_name], plan)[loss_name]

    return check_gradients_fn(
        loss_fn, {n: sd._arrays[n] for n in trainable}, eps=eps,
        max_rel_error=max_rel_error, min_abs_error=DEFAULT_MIN_ABS_ERROR,
        max_per_param=max_per_param, seed=seed, print_failures=True)
