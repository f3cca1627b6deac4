"""Loss-function catalog — ND4J's ILossFunction set.

Counterpart of ``deeplearning4j_tpu/ops/losses.py``: the same names and
math. A loss is ``(predictions, labels, mask=None, weights=None) -> scalar``
averaged per example like the reference's ``computeScore(average=true)``;
activations are applied by the caller (the output layer). Gradients come
from autograd.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch


def _apply_mask_and_mean(per_example, mask):
    """per_example: [B] or [B,T] score per example; mask broadcastable."""
    if mask is not None:
        m = mask.to(per_example.dtype)
        while m.ndim > per_example.ndim:
            m = m.squeeze(-1)
        per_example = per_example * m
        return torch.sum(per_example) / torch.clamp_min(torch.sum(m), 1.0)
    return torch.mean(per_example)


def _reduce_feature_axis(x, weights=None):
    if weights is not None:
        x = x * weights
    return torch.sum(x, dim=-1)


def mcxent(probs, labels, mask=None, weights=None, *, eps: float = 1e-8):
    """Multi-class cross entropy on probabilities (LossMCXENT)."""
    ll = labels * torch.log(torch.clamp(probs, eps, 1.0))
    return _apply_mask_and_mean(-_reduce_feature_axis(ll, weights), mask)


def softmax_cross_entropy_with_logits(logits, labels, mask=None, weights=None):
    """Fused stable softmax+CE (the path LossMCXENT takes with softmax)."""
    lse = torch.log_softmax(logits, dim=-1)
    return _apply_mask_and_mean(-_reduce_feature_axis(labels * lse, weights),
                                mask)


def sparse_mcxent(logits, label_ids, mask=None):
    """LossSparseMCXENT: integer labels, stable log-softmax gather."""
    lse = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(lse, -1, label_ids[..., None].long())[..., 0]
    return _apply_mask_and_mean(-ll, mask)


def negative_log_likelihood(probs, labels, mask=None, weights=None):
    """LossNegativeLogLikelihood — same math as MCXENT in the reference."""
    return mcxent(probs, labels, mask, weights)


def binary_xent(probs, labels, mask=None, weights=None, *, eps: float = 1e-8):
    """LossBinaryXENT on probabilities (sigmoid applied by caller)."""
    p = torch.clamp(probs, eps, 1.0 - eps)
    ll = labels * torch.log(p) + (1.0 - labels) * torch.log(1.0 - p)
    return _apply_mask_and_mean(-_reduce_feature_axis(ll, weights), mask)


def sigmoid_cross_entropy_with_logits(logits, labels, mask=None,
                                      weights=None):
    per = (torch.clamp_min(logits, 0) - logits * labels
           + torch.log1p(torch.exp(-torch.abs(logits))))
    return _apply_mask_and_mean(_reduce_feature_axis(per, weights), mask)


def mse(preds, labels, mask=None, weights=None):
    """LossMSE: mean over the output dimension."""
    per = (preds - labels) ** 2
    if weights is not None:
        per = per * weights
    return _apply_mask_and_mean(torch.mean(per, dim=-1), mask)


def l2(preds, labels, mask=None, weights=None):
    """LossL2: sum of squared errors (no /nOut)."""
    return _apply_mask_and_mean(
        _reduce_feature_axis((preds - labels) ** 2, weights), mask)


def mae(preds, labels, mask=None, weights=None):
    per = torch.abs(preds - labels)
    if weights is not None:
        per = per * weights
    return _apply_mask_and_mean(torch.mean(per, dim=-1), mask)


def l1(preds, labels, mask=None, weights=None):
    return _apply_mask_and_mean(
        _reduce_feature_axis(torch.abs(preds - labels), weights), mask)


def mape(preds, labels, mask=None, weights=None, *, eps: float = 1e-8):
    per = torch.abs((labels - preds)
                    / torch.clamp_min(torch.abs(labels), eps)) * 100.0
    if weights is not None:
        per = per * weights
    return _apply_mask_and_mean(torch.mean(per, dim=-1), mask)


def msle(preds, labels, mask=None, weights=None):
    per = (torch.log1p(torch.clamp_min(preds, -1 + 1e-7))
           - torch.log1p(torch.clamp_min(labels, -1 + 1e-7))) ** 2
    if weights is not None:
        per = per * weights
    return _apply_mask_and_mean(torch.mean(per, dim=-1), mask)


def poisson(preds, labels, mask=None, weights=None, *, eps: float = 1e-8):
    per = preds - labels * torch.log(torch.clamp_min(preds, eps))
    return _apply_mask_and_mean(_reduce_feature_axis(per, weights), mask)


def kl_divergence(preds, labels, mask=None, weights=None, *,
                  eps: float = 1e-8):
    per = labels * (torch.log(torch.clamp(labels, eps, 1.0))
                    - torch.log(torch.clamp(preds, eps, 1.0)))
    return _apply_mask_and_mean(_reduce_feature_axis(per, weights), mask)


def hinge(preds, labels, mask=None, weights=None):
    """LossHinge: labels in {-1, +1}."""
    per = torch.clamp_min(1.0 - labels * preds, 0.0)
    return _apply_mask_and_mean(_reduce_feature_axis(per, weights), mask)


def squared_hinge(preds, labels, mask=None, weights=None):
    per = torch.clamp_min(1.0 - labels * preds, 0.0) ** 2
    return _apply_mask_and_mean(_reduce_feature_axis(per, weights), mask)


def cosine_proximity(preds, labels, mask=None, weights=None, *,
                     eps: float = 1e-8):
    pn = preds / torch.clamp_min(
        torch.linalg.vector_norm(preds, dim=-1, keepdim=True), eps)
    ln = labels / torch.clamp_min(
        torch.linalg.vector_norm(labels, dim=-1, keepdim=True), eps)
    return _apply_mask_and_mean(-torch.sum(pn * ln, dim=-1), mask)


def wasserstein(preds, labels, mask=None, weights=None):
    """LossWasserstein: mean(labels * preds) (critic loss form)."""
    return _apply_mask_and_mean(torch.mean(labels * preds, dim=-1), mask)


def yolo2(pred, target, mask=None, *, lambda_coord: float = 5.0,
          lambda_noobj: float = 0.5, anchors=None):
    """YOLOv2 multi-part sum-squared objective (Yolo2OutputLayer
    computeScore analog); pred (N,H,W,B*(5+C)) or (N,H,W,B,5+C), target
    (N,H,W,B,5+C) = [x, y, w, h, objectness, class one-hot...]."""
    n, gh, gw = target.shape[0], target.shape[1], target.shape[2]
    bx, depth = target.shape[3], target.shape[4]
    p = pred.reshape(n, gh, gw, bx, depth)
    xy = torch.sigmoid(p[..., 0:2])
    if anchors is not None:
        a = torch.as_tensor(anchors, dtype=p.dtype,
                            device=p.device).reshape(1, 1, 1, bx, 2)
        wh = a * torch.exp(p[..., 2:4])
    else:
        wh = p[..., 2:4]
    obj = torch.sigmoid(p[..., 4])
    cls = torch.softmax(p[..., 5:], dim=-1)
    t_obj = target[..., 4]
    if mask is not None:
        cell = mask.reshape(n, gh, gw, 1)
        t_obj = t_obj * cell
        noobj_w = (1 - target[..., 4]) * cell
    else:
        noobj_w = 1 - t_obj
    coord = torch.sum(t_obj[..., None] * ((xy - target[..., 0:2]) ** 2
                                          + (wh - target[..., 2:4]) ** 2))
    obj_term = torch.sum(t_obj * (obj - 1.0) ** 2)
    noobj = torch.sum(noobj_w * obj ** 2)
    cls_term = torch.sum(t_obj[..., None] * (cls - target[..., 5:]) ** 2)
    return (lambda_coord * coord + obj_term + lambda_noobj * noobj
            + cls_term) / n


# name table of DL4J's LossFunctions.LossFunction enum
LOSSES: Dict[str, Callable] = {
    "mcxent": mcxent,
    "negativeloglikelihood": negative_log_likelihood,
    "sparse_mcxent": sparse_mcxent,
    "xent": binary_xent,
    "mse": mse,
    "squared_loss": mse,
    "l2": l2,
    "mean_absolute_error": mae,
    "l1": l1,
    "mean_absolute_percentage_error": mape,
    "mean_squared_logarithmic_error": msle,
    "poisson": poisson,
    "kl_divergence": kl_divergence,
    "reconstruction_crossentropy": binary_xent,
    "hinge": hinge,
    "squared_hinge": squared_hinge,
    "cosine_proximity": cosine_proximity,
    "wasserstein": wasserstein,
    "yolo2": yolo2,
}


def get_loss(name_or_fn) -> Callable:
    if callable(name_or_fn):
        return name_or_fn
    name = str(name_or_fn).lower()
    try:
        return LOSSES[name]
    except KeyError:
        raise ValueError(f"unknown loss '{name_or_fn}'; known: "
                         f"{sorted(LOSSES)}") from None
